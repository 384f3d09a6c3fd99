"""Half-pi parametric rotations -> Clifford gate expansion.

Feature parity with reference ``src/tsim/utils/clifford.py:67,105,150``:
detect Clifford circuits (tagged rotations at half-pi angles count) and
expand half-pi-angle tagged rotations into plain Clifford gates. The U3 and
axis-rotation lookup tables are mathematical constants and necessarily match
the reference; everything around them is organized as a non-Clifford-witness
iterator plus a single per-instruction replacement resolver.
"""

from __future__ import annotations

from fractions import Fraction

from ..core.parse import parse_parametric_tag
from ..core.tags import is_t_tag
from ..stim_core import Circuit as StimCircuit
from ..stim_core.instruction import CircuitInstruction, CircuitRepeatBlock

# U3(theta, phi, lambda) = R_Z(phi) R_Y(theta) R_Z(lambda) at half-pi angle
# indices (theta_idx, phi_idx, lambda_idx), each in {0..3}; values are gate
# names in circuit (time) order. Keys absent here are reached through the
# global-phase equivalence U3(t,p,l) == U3(2pi-t, p+pi, l+pi), see _mirror_u3.
U3_CLIFFORD: dict[tuple[int, int, int], list[str]] = {
    (0, 0, 0): ["I"],
    (0, 0, 1): ["S"],
    (0, 0, 2): ["Z"],
    (0, 0, 3): ["S_DAG"],
    (0, 1, 0): ["S"],
    (0, 1, 1): ["Z"],
    (0, 1, 2): ["S_DAG"],
    (0, 1, 3): ["I"],
    (1, 0, 0): ["SQRT_Y"],
    (1, 0, 1): ["S", "SQRT_Y"],
    (1, 0, 2): ["H"],
    (1, 0, 3): ["S_DAG", "SQRT_Y"],
    (1, 1, 0): ["S", "SQRT_X_DAG"],
    (1, 1, 1): ["Z", "SQRT_X_DAG"],
    (1, 1, 2): ["S_DAG", "SQRT_X_DAG"],
    (1, 1, 3): ["SQRT_X_DAG"],
    (1, 2, 0): ["Z", "SQRT_Y_DAG"],
    (1, 2, 1): ["S_DAG", "SQRT_Y_DAG"],
    (1, 2, 2): ["SQRT_Y_DAG"],
    (1, 2, 3): ["S", "SQRT_Y_DAG"],
    (1, 3, 0): ["S_DAG", "SQRT_X"],
    (1, 3, 1): ["SQRT_X"],
    (1, 3, 2): ["S", "SQRT_X"],
    (1, 3, 3): ["Z", "SQRT_X"],
    (2, 0, 0): ["Y"],
    (2, 0, 1): ["S", "Y"],
    (2, 0, 2): ["X"],
    (2, 0, 3): ["S_DAG", "Y"],
    (2, 1, 0): ["Y", "S"],
    (2, 1, 1): ["Y"],
    (2, 1, 2): ["S", "Y"],
    (2, 1, 3): ["X"],
}

# k quarter-turns about each axis, k = 0..3.
RZ_CLIFFORD = {0: "I", 1: "S", 2: "Z", 3: "S_DAG"}
RX_CLIFFORD = {0: "I", 1: "SQRT_X", 2: "X", 3: "SQRT_X_DAG"}
RY_CLIFFORD = {0: "I", 1: "SQRT_Y", 2: "Y", 3: "SQRT_Y_DAG"}

_AXIS_TABLES = {"R_Z": RZ_CLIFFORD, "R_X": RX_CLIFFORD, "R_Y": RY_CLIFFORD}
_U3_ANGLES = ("theta", "phi", "lambda")


def _half_pi_steps(angle: Fraction) -> int | None:
    """Angle (units of pi) as a count of half-pi steps mod 4, or None."""
    return int(angle * 2) % 4 if angle.denominator <= 2 else None


def _mirror_u3(t: int, p: int, lam: int) -> tuple[int, int, int]:
    return ((4 - t) % 4, (p + 2) % 4, (lam + 2) % 4)


def parametric_to_clifford_gates(gate_name: str, params) -> list[str] | None:
    """Gate names (circuit order) realizing a half-pi rotation, else None."""
    if gate_name == "U3":
        steps = tuple(_half_pi_steps(params[k]) for k in _U3_ANGLES)
        if None in steps:
            return None
        hit = U3_CLIFFORD.get(steps)
        if hit is None:
            hit = U3_CLIFFORD[_mirror_u3(*steps)]
        return list(hit)
    axis_table = _AXIS_TABLES.get(gate_name)
    if axis_table is None:
        return None
    k = _half_pi_steps(params["theta"])
    return None if k is None else [axis_table[k]]


# --- Clifford detection ------------------------------------------------------


def _breaks_clifford(ins: CircuitInstruction) -> bool:
    """True when this single instruction is non-Clifford."""
    if ins.name in ("S", "S_DAG", "SPP", "SPP_DAG") and is_t_tag(ins.tag):
        return True
    if not ins.tag:
        return False
    if ins.name in ("SPP", "SPP_DAG"):
        parsed = parse_parametric_tag(ins)
        return parsed is not None and parsed[1]["theta"].denominator > 2
    if ins.name == "I":
        parsed = parse_parametric_tag(ins)
        if parsed is None:
            return False
        gate_name, params = parsed
        if gate_name == "U3":
            return any(params[k].denominator > 2 for k in _U3_ANGLES)
        if gate_name in _AXIS_TABLES:
            return params["theta"].denominator > 2
        return True
    return False


def iter_nonclifford(source: StimCircuit):
    """Yield every instruction that makes the circuit non-Clifford."""
    for ins in source:
        if isinstance(ins, CircuitRepeatBlock):
            yield from iter_nonclifford(ins.body_copy())
        elif _breaks_clifford(ins):
            yield ins


def is_clifford(source: StimCircuit) -> bool:
    """True iff every instruction is Clifford (recursing into REPEATs)."""
    return next(iter_nonclifford(source), None) is None


# --- Clifford-angle expansion -------------------------------------------------

_SPP_POWERS = ((), ("SPP",), ("SPP", "SPP"), ("SPP_DAG",))


def _clifford_replacement(ins: CircuitInstruction):
    """Replacement [(gate, targets), ...] for a half-pi tagged rotation.

    None means 'not expandable here — keep the instruction as written'.
    An empty list is a valid replacement (identity rotation drops out).
    """
    if not ins.tag:
        return None
    parsed = parse_parametric_tag(ins)
    if parsed is None:
        return None
    gate_name, params = parsed
    if ins.name in ("SPP", "SPP_DAG"):
        if gate_name != "R_PAULI":
            return None
        k = _half_pi_steps(params["theta"])
        if k is None:
            return None
        if ins.name == "SPP_DAG":
            k = -k % 4
        targets = ins.targets_copy()
        return [(name, targets) for name in _SPP_POWERS[k]]
    if ins.name == "I":
        gates = parametric_to_clifford_gates(gate_name, params)
        if gates is None:
            return None
        qubits = [t.value for t in ins.targets_copy()]
        return [(name, qubits) for name in gates]
    return None


def expand_clifford_rotations(source: StimCircuit) -> StimCircuit:
    """Expand half-pi parametric rotations into plain Clifford gates."""
    out = StimCircuit()
    for ins in source:
        if isinstance(ins, CircuitRepeatBlock):
            out.append(
                CircuitRepeatBlock(
                    ins.repeat_count, expand_clifford_rotations(ins.body_copy())
                )
            )
            continue
        replacement = _clifford_replacement(ins)
        if replacement is None:
            out.append(ins)
        else:
            for name, targets in replacement:
                out.append(name, targets, None)
    return out
