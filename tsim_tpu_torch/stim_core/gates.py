"""Gate data table for the Stim dialect.

In-house replacement for ``stim.gate_data`` (the reference depends on the
Stim wheel for this; see reference ``SURVEY.md`` section 2.1 row 1). Each
entry records arity grouping, argument arity, measurement production, and
classification flags used by the parser, counters, inverse, and DEM builder.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class GateData:
    name: str
    arity: int  # qubits per application group (0 = special)
    num_args: tuple[int, int]  # (min, max) parens arguments; -1 = unlimited
    produces_measurements: bool = False
    is_noise: bool = False
    is_unitary: bool = False
    is_reset: bool = False
    is_annotation: bool = False
    takes_pauli_targets: bool = False
    # Combiners (``*``) join pauli targets into products; only the pauli
    # product instructions accept them (correlated errors take bare pauli
    # targets — stim rejects ``E(0.1) X0*X1``).
    takes_combiners: bool = False
    takes_rec_targets: bool = False
    inverse: str | None = None  # name of inverse gate (unitary only)


_G: dict[str, GateData] = {}


def _add(
    name,
    arity=1,
    args=(0, 0),
    inverse=None,
    **kw,
):
    _G[name] = GateData(name=name, arity=arity, num_args=args, inverse=inverse, **kw)


# ---- Pauli + identity ----
_add("I", 1, is_unitary=True, inverse="I", args=(0, 99))
_add("II", 2, is_unitary=True, inverse="II")
_add("X", 1, is_unitary=True, inverse="X")
_add("Y", 1, is_unitary=True, inverse="Y")
_add("Z", 1, is_unitary=True, inverse="Z")

# ---- single-qubit Cliffords ----
for nm, inv in [
    ("H", "H"),
    ("H_XY", "H_XY"),
    ("H_YZ", "H_YZ"),
    ("H_NXY", "H_NXY"),
    ("H_NXZ", "H_NXZ"),
    ("H_NYZ", "H_NYZ"),
    ("S", "S_DAG"),
    ("S_DAG", "S"),
    ("SQRT_X", "SQRT_X_DAG"),
    ("SQRT_X_DAG", "SQRT_X"),
    ("SQRT_Y", "SQRT_Y_DAG"),
    ("SQRT_Y_DAG", "SQRT_Y"),
    ("SQRT_Z", "SQRT_Z_DAG"),
    ("SQRT_Z_DAG", "SQRT_Z"),
    ("C_XYZ", "C_ZYX"),
    ("C_ZYX", "C_XYZ"),
    ("C_NXYZ", "C_ZYNX"),
    ("C_XNYZ", "C_ZNYX"),
    ("C_XYNZ", "C_NZYX"),
    ("C_NZYX", "C_XYNZ"),
    ("C_ZNYX", "C_XNYZ"),
    ("C_ZYNX", "C_NXYZ"),
]:
    _add(nm, 1, is_unitary=True, inverse=inv)
_G["H_XZ"] = _G["H"]

# ---- two-qubit gates ----
for nm, inv in [
    ("CX", "CX"),
    ("CNOT", "CNOT"),
    ("ZCX", "ZCX"),
    ("CY", "CY"),
    ("ZCY", "ZCY"),
    ("CZ", "CZ"),
    ("ZCZ", "ZCZ"),
    ("XCX", "XCX"),
    ("XCY", "XCY"),
    ("XCZ", "XCZ"),
    ("YCX", "YCX"),
    ("YCY", "YCY"),
    ("YCZ", "YCZ"),
    ("SWAP", "SWAP"),
    ("ISWAP", "ISWAP_DAG"),
    ("ISWAP_DAG", "ISWAP"),
    ("CXSWAP", "SWAPCX"),
    ("SWAPCX", "CXSWAP"),
    ("CZSWAP", "CZSWAP"),
    ("SWAPCZ", "SWAPCZ"),
    ("SQRT_XX", "SQRT_XX_DAG"),
    ("SQRT_XX_DAG", "SQRT_XX"),
    ("SQRT_YY", "SQRT_YY_DAG"),
    ("SQRT_YY_DAG", "SQRT_YY"),
    ("SQRT_ZZ", "SQRT_ZZ_DAG"),
    ("SQRT_ZZ_DAG", "SQRT_ZZ"),
]:
    _add(nm, 2, is_unitary=True, inverse=inv, takes_rec_targets=nm in (
        "CX", "CNOT", "ZCX", "CY", "ZCY", "CZ", "ZCZ", "XCZ", "YCZ"))

# ---- Pauli product gates ----
_add("SPP", 0, is_unitary=True, inverse="SPP_DAG", takes_pauli_targets=True, takes_combiners=True)
_add("SPP_DAG", 0, is_unitary=True, inverse="SPP", takes_pauli_targets=True, takes_combiners=True)

# ---- noise channels ----
_add("X_ERROR", 1, args=(1, 1), is_noise=True)
_add("Y_ERROR", 1, args=(1, 1), is_noise=True)
_add("Z_ERROR", 1, args=(1, 1), is_noise=True)
_add("I_ERROR", 1, args=(0, 99), is_noise=True)
_add("II_ERROR", 2, args=(0, 99), is_noise=True)
_add("DEPOLARIZE1", 1, args=(1, 1), is_noise=True)
_add("DEPOLARIZE2", 2, args=(1, 1), is_noise=True)
_add("PAULI_CHANNEL_1", 1, args=(3, 3), is_noise=True)
_add("PAULI_CHANNEL_2", 2, args=(15, 15), is_noise=True)
_add("HERALDED_ERASE", 1, args=(1, 1), is_noise=True, produces_measurements=True)
_add(
    "HERALDED_PAULI_CHANNEL_1",
    1,
    args=(4, 4),
    is_noise=True,
    produces_measurements=True,
)
_add("E", 0, args=(1, 1), is_noise=True, takes_pauli_targets=True)
_G["CORRELATED_ERROR"] = _G["E"]
_add("ELSE_CORRELATED_ERROR", 0, args=(1, 1), is_noise=True, takes_pauli_targets=True)

# ---- collapsing gates ----
for nm in ["M", "MZ", "MX", "MY"]:
    _add(nm, 1, args=(0, 1), produces_measurements=True)
for nm in ["MR", "MRZ", "MRX", "MRY"]:
    _add(nm, 1, args=(0, 1), produces_measurements=True, is_reset=True)
for nm in ["MXX", "MYY", "MZZ"]:
    _add(nm, 2, args=(0, 1), produces_measurements=True)
_add("MPP", 0, args=(0, 1), produces_measurements=True, takes_pauli_targets=True, takes_combiners=True)
_add("MPAD", 1, args=(0, 1), produces_measurements=True)
for nm in ["R", "RZ", "RX", "RY"]:
    _add(nm, 1, is_reset=True)

# ---- annotations ----
_add("DETECTOR", 0, args=(0, 99), is_annotation=True, takes_rec_targets=True)
_add(
    "OBSERVABLE_INCLUDE",
    0,
    args=(1, 1),
    is_annotation=True,
    takes_rec_targets=True,
)
_add("QUBIT_COORDS", 1, args=(0, 99), is_annotation=True)
_add("SHIFT_COORDS", 0, args=(0, 99), is_annotation=True)
_add("TICK", 0, is_annotation=True)
_add("MPAD_", 0)  # placeholder guard, never parsed
del _G["MPAD_"]


GATE_DATA = _G


def gate_data(name: str) -> GateData:
    d = _G.get(name.upper())
    if d is None:
        raise ValueError(f"Gate not found: '{name}'")
    return d


def is_gate(name: str) -> bool:
    return name.upper() in _G
