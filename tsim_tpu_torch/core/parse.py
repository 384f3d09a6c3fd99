"""Parser from Stim-dialect circuits to ZX graph representations.

Semantics mirror reference ``tsim/core/parse.py``: parametric tags on ``I``
and ``SPP`` instructions, T tags on ``S``/``SPP``, Pauli-product iteration
with full Pauli algebra, correlated-error chains, detector/observable
annotations, and generic gate dispatch with invert / classical-control
flags.
"""

from __future__ import annotations

import re
from fractions import Fraction
from typing import Iterator, Literal

from ..stim_core import Circuit as StimCircuit
from ..stim_core.instruction import CircuitInstruction, CircuitRepeatBlock
from .instructions import (
    GATE_TABLE,
    GraphRepresentation,
    correlated_error,
    detector,
    finalize_correlated_error,
    mpad,
    mpp,
    observable_include,
    r_pauli,
    r_x,
    r_y,
    r_z,
    spp,
    tick,
    tpp,
    u3,
)
from .tags import is_t_tag

_PARAMETRIC_GATE_PARAMS: dict[str, frozenset[str]] = {
    "R_X": frozenset({"theta"}),
    "R_Y": frozenset({"theta"}),
    "R_Z": frozenset({"theta"}),
    "R_PAULI": frozenset({"theta"}),
    "U3": frozenset({"theta", "phi", "lambda"}),
}

R_PAULI_MAX_QUBITS = 64

# Non-dyadic angles (decimal strings like 0.3*pi parse to denominator 10^16)
# are canonicalized to the nearest 2^-40 dyadic at the parser chokepoint.
# Clifford/T angles (denominator 1, 2, 4, 8...) are exactly representable and
# untouched; arbitrary angles are evaluated in double precision downstream
# (stabilizer decomposition pulls them out as float cos/sin factors), so the
# ~1e-12 rounding is far below sampling precision. Keeping every phase
# dyadic bounds Fraction arithmetic (sums take the max denominator instead
# of the lcm product, which grew to >100-bit integers with decimal inputs)
# and keeps the native ZX engine's int64 fractions exact.
_ANGLE_DEN_BITS = 40


def canonical_angle(f: Fraction) -> Fraction:
    den = f.denominator
    if den & (den - 1) == 0 and den.bit_length() <= _ANGLE_DEN_BITS + 1:
        return f
    scale = 1 << _ANGLE_DEN_BITS
    return Fraction(round(f * scale), scale)


_TAG_RE = re.compile(r"^(\w+)\((.*)\)$")
_PARAM_RE = re.compile(r"^(\w+)=([-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?)\*pi$")


def parse_parametric_tag(
    instruction: CircuitInstruction,
) -> tuple[str, dict[str, Fraction]] | None:
    """Parse a parametric tag like ``R_Z(theta=0.3*pi)`` on an instruction."""
    tag = instruction.tag
    err_prefix = f"Could not parse instruction {str(instruction)!r}"
    m = _TAG_RE.match(tag)
    if not m:
        return None
    gate_name = m.group(1)
    params: dict[str, Fraction] = {}
    for param in m.group(2).split(","):
        param = param.strip()
        if not param:
            continue
        pm = _PARAM_RE.match(param)
        if not pm:
            raise ValueError(f"{err_prefix}. Malformed parametric tag {tag!r}")
        params[pm.group(1)] = canonical_angle(Fraction(pm.group(2)))
    expected = _PARAMETRIC_GATE_PARAMS.get(gate_name)
    if expected is None:
        raise ValueError(f"{err_prefix}. Unknown parametric gate {gate_name!r}")
    if params.keys() != expected:
        raise ValueError(
            f"{err_prefix}. Parametric tag {tag!r} has parameters "
            f"{sorted(params)}, expected {sorted(expected)}"
        )
    return gate_name, params


_PAULI_PRODUCT: dict[tuple[str, str], tuple[str, int]] = {
    ("X", "Y"): ("Z", 1),
    ("X", "Z"): ("Y", 3),
    ("Y", "X"): ("Z", 3),
    ("Y", "Z"): ("X", 1),
    ("Z", "X"): ("Y", 1),
    ("Z", "Y"): ("X", 3),
}


def _pauli_letter(t) -> Literal["X", "Y", "Z"]:
    """Map a Pauli target to its letter; raise on non-Pauli targets."""
    if t.is_x_target:
        return "X"
    if t.is_y_target:
        return "Y"
    if t.is_z_target:
        return "Z"
    raise ValueError(f"Invalid target: {t}")


def _validate_r_pauli_targets(instruction: CircuitInstruction) -> None:
    targets = instruction.targets_copy()
    total = sum(1 for t in targets if not t.is_combiner)
    if total > R_PAULI_MAX_QUBITS:
        raise ValueError(
            f"R_PAULI supports at most {R_PAULI_MAX_QUBITS} qubits per instruction, "
            f"got {total}."
        )
    seen: set[int] = set()
    for idx, t in enumerate(targets):
        if t.is_combiner:
            continue
        if t.value in seen:
            raise ValueError(
                f"R_PAULI target qubits must be distinct within a product, "
                f"got repeated qubit {t.value} in {str(instruction)!r}."
            )
        seen.add(t.value)
        nxt = idx + 1
        if nxt >= len(targets) or not targets[nxt].is_combiner:
            seen = set()


def _iter_pauli_products(
    instruction: CircuitInstruction,
) -> Iterator[tuple[list[tuple[str, int]], bool]]:
    """Yield (paulis, invert) per product, applying Pauli algebra on repeats."""
    qubit_pauli: dict[int, str] = {}
    sign = 0  # power of i mod 4
    invert = False
    targets = instruction.targets_copy()
    for idx, t in enumerate(targets):
        if t.is_combiner:
            continue
        try:
            pt = _pauli_letter(t)
        except ValueError:
            raise ValueError(
                f"Invalid Pauli target in instruction {instruction.name}: {t}"
            ) from None
        invert ^= t.is_inverted_result_target
        q = t.value
        if q not in qubit_pauli:
            qubit_pauli[q] = pt
        elif qubit_pauli[q] == pt:
            del qubit_pauli[q]
        else:
            res, delta = _PAULI_PRODUCT[qubit_pauli[q], pt]
            qubit_pauli[q] = res
            sign = (sign + delta) % 4
        nxt = idx + 1
        if nxt >= len(targets) or not targets[nxt].is_combiner:
            if sign % 2 == 1:
                raise ValueError(f"{instruction} acted on an anti-Hermitian operator")
            paulis = [(p, q) for q, p in sorted(qubit_pauli.items())]
            yield paulis, invert ^ (sign == 2)
            qubit_pauli = {}
            sign = 0
            invert = False


# ---------------------------------------------------------------------------
# Instruction handlers.
#
# ``parse_stim_circuit`` dispatches each instruction through ``_HANDLERS``
# (one entry per instruction family with bespoke construction logic); anything
# not claimed by a handler flows through the generic GATE_TABLE path. A
# handler returns True when it consumed the instruction and False to decline
# (e.g. a bare ``I`` falls back to the identity builder in GATE_TABLE).
# ---------------------------------------------------------------------------

_ROTATION_BUILDERS = {
    "R_X": lambda b, q, ps: r_x(b, q, ps["theta"]),
    "R_Y": lambda b, q, ps: r_y(b, q, ps["theta"]),
    "R_Z": lambda b, q, ps: r_z(b, q, ps["theta"]),
    "U3": lambda b, q, ps: u3(b, q, ps["theta"], ps["phi"], ps["lambda"]),
}


def _noise_arg(ins: CircuitInstruction) -> float:
    """First gate argument, defaulting to 0 (probability-style args)."""
    args = ins.gate_args_copy()
    return args[0] if args else 0


def _on_identity(b: GraphRepresentation, ins: CircuitInstruction) -> bool:
    # A tagged I carries a single-qubit continuous rotation; untagged or
    # unparsable-tag I declines to the GATE_TABLE identity builder.
    if not ins.tag:
        return False
    parsed = parse_parametric_tag(ins)
    if parsed is None:
        return False
    gate_name, params = parsed
    build = _ROTATION_BUILDERS.get(gate_name)
    if build is None:
        raise ValueError(f"Unknown parametric gate: {gate_name}")
    for t in ins.targets_copy():
        build(b, t.value, params)
    return True


def _on_tick(b: GraphRepresentation, ins: CircuitInstruction) -> bool:
    tick(b)
    return True


def _on_mpp(b: GraphRepresentation, ins: CircuitInstruction) -> bool:
    p = _noise_arg(ins)
    for paulis, neg in _iter_pauli_products(ins):
        mpp(b, paulis, neg, p=p)
    return True


def _on_spp(b: GraphRepresentation, ins: CircuitInstruction) -> bool:
    # Three flavours share the Pauli-product walk: T-tagged (tpp),
    # R_PAULI-tagged (continuous rotation), and bare/other-tag (Clifford spp).
    adjoint = ins.name == "SPP_DAG"
    theta = None
    if not is_t_tag(ins.tag):
        if ins.tag:
            parsed = parse_parametric_tag(ins)
            if parsed is not None and parsed[0] == "R_PAULI":
                _validate_r_pauli_targets(ins)
                theta = parsed[1]["theta"]
        for paulis, neg in _iter_pauli_products(ins):
            if theta is not None:
                r_pauli(b, paulis, theta, dagger=adjoint ^ neg)
            else:
                spp(b, paulis, dagger=adjoint ^ neg)
        return True
    for paulis, neg in _iter_pauli_products(ins):
        tpp(b, paulis, dagger=adjoint ^ neg)
    return True


def _on_mpad(b: GraphRepresentation, ins: CircuitInstruction) -> bool:
    p = _noise_arg(ins)
    for t in ins.targets_copy():
        mpad(b, t.value, p=p)
    return True


def _on_correlated_error(b: GraphRepresentation, ins: CircuitInstruction) -> bool:
    if ins.name != "ELSE_CORRELATED_ERROR":
        finalize_correlated_error(b)
    targets = ins.targets_copy()
    correlated_error(
        b,
        [t.value for t in targets],
        [_pauli_letter(t) for t in targets],
        ins.gate_args_copy()[0],
    )
    return True


def _on_detector(b: GraphRepresentation, ins: CircuitInstruction) -> bool:
    detector(b, [t.value for t in ins.targets_copy()])
    return True


def _on_observable(b: GraphRepresentation, ins: CircuitInstruction) -> bool:
    targets = ins.targets_copy()
    bad = [t for t in targets if not t.is_measurement_record_target]
    if bad:
        raise ValueError(
            f"OBSERVABLE_INCLUDE with Pauli targets is not "
            f"supported (only measurement record targets "
            f"like rec[-1] are supported). Got instruction "
            f"{str(ins)!r}"
        )
    observable_include(
        b, [t.value for t in targets], int(ins.gate_args_copy()[0])
    )
    return True


_HANDLERS = {
    "I": _on_identity,
    "TICK": _on_tick,
    "MPP": _on_mpp,
    "SPP": _on_spp,
    "SPP_DAG": _on_spp,
    "MPAD": _on_mpad,
    "E": _on_correlated_error,
    "CORRELATED_ERROR": _on_correlated_error,
    "ELSE_CORRELATED_ERROR": _on_correlated_error,
    "DETECTOR": _on_detector,
    "OBSERVABLE_INCLUDE": _on_observable,
}

# S/S_DAG carrying the T marker tag are really T/T_DAG.
_T_TAG_RENAMES = {"S": "T", "S_DAG": "T_DAG"}


def _apply_table_gate(
    b: GraphRepresentation, name: str, ins: CircuitInstruction
) -> None:
    """Generic gate path: chunk targets by arity, honouring invert / rec flags."""
    entry = GATE_TABLE.get(name)
    if entry is None:
        raise ValueError(f"Unknown gate: {name}")
    build, arity = entry
    targets = ins.targets_copy()
    args = ins.gate_args_copy()
    for start in range(0, len(targets), arity):
        group = targets[start : start + arity]
        head = group[0]
        assert not (head.is_inverted_result_target and head.is_measurement_record_target)
        flip = False
        for t in group:
            flip ^= t.is_inverted_result_target
        values = [t.value for t in group]
        if flip:
            build(b, *values, *args, invert=True)
            continue
        rec_flags = [t.is_measurement_record_target for t in group]
        if any(rec_flags):
            build(b, *values, *args, classically_controlled=rec_flags)
        else:
            build(b, *values, *args)


def parse_stim_circuit(stim_circuit: StimCircuit) -> GraphRepresentation:
    """Parse a (stim-core) circuit into a GraphRepresentation."""
    b = GraphRepresentation()

    for instruction in stim_circuit.flattened():
        assert not isinstance(instruction, CircuitRepeatBlock)
        if any(t.is_sweep_bit_target for t in instruction.targets_copy()):
            raise NotImplementedError(
                f"Sweep bit targets (e.g. sweep[N]) are not supported "
                f"in instruction {str(instruction)!r}"
            )
        name = instruction.name
        if name == "SHIFT_COORDS":
            continue
        if is_t_tag(instruction.tag):
            name = _T_TAG_RENAMES.get(name, name)
        handler = _HANDLERS.get(name)
        if handler is not None and handler(b, instruction):
            continue
        _apply_table_gate(b, name, instruction)

    finalize_correlated_error(b)

    # Materialize missing observable ids as deterministic-zero placeholders
    # and keep the dict sorted by index.
    for idx in range(stim_circuit.num_observables):
        if idx not in b.observables_dict:
            observable_include(b, [], idx)
    b.observables_dict = {i: b.observables_dict[i] for i in sorted(b.observables_dict)}
    return b
