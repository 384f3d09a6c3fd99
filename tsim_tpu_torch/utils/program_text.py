"""tsim shorthand <-> Stim-dialect program text conversion.

Same rewrite-table *semantics* as the reference (reference
``src/tsim/utils/program_text.py:126,227``): T/TPP/R_*/U3 shorthand becomes
tagged Stim instructions and back, CCZ/CCX expand to Clifford+T lines.
Implementation here is table-driven: the CCZ sequence, the T-family renames
and both rewrite directions are data applied by one small engine.
"""

from __future__ import annotations

import re

from ..core.tags import decode_t_user_tag, encode_t_tag

FLOAT_RE = r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?"

_TSIM_GATES = {
    "CCZ", "CCX", "R_X", "R_Y", "R_Z", "R_XX", "R_YY", "R_ZZ", "R_PAULI", "U3",
}
_GATE_NOT_FOUND_RE = re.compile(r"Gate not found: '(\w+)'")
_GATE_USAGE_RE = re.compile(
    r"(?<!\[)\b(CCZ\b|CCX\b|R_PAULI\([^)]*\)|R_[XYZ]{1,2}\([^)]*\)|R_[XYZ]\b|U3\([^)]*\)|U3\b)"
)

# Standard 7-T CCZ circuit over (a, b, c) = (control1, control2, target),
# stored as (gate, operand letters). CCX wraps it in H on the target.
_CCZ_SEQUENCE = (
    ("CNOT", "bc"), ("T_DAG", "c"), ("CNOT", "ac"), ("T", "c"),
    ("CNOT", "bc"), ("T_DAG", "c"), ("CNOT", "ac"), ("T", "b"),
    ("T", "c"), ("CNOT", "ab"), ("T", "a"), ("T_DAG", "b"), ("CNOT", "ab"),
)

# Shorthand gate name -> Stim gate name, in match-priority order (longer
# names first so e.g. TPP_DAG never partially matches as T).
_T_FAMILY = (
    ("TPP_DAG", "SPP_DAG"),
    ("TPP", "SPP"),
    ("T_DAG", "S_DAG"),
    ("T", "S"),
)


def controlled_gate_decomposition_lines(
    gate: str,
    control1,
    control2,
    target,
    *,
    tag: str = "",
) -> list[str]:
    """Clifford+T decomposition of CCZ / CCX as program-text lines."""
    if gate not in ("CCZ", "CCX"):
        raise ValueError(f"Unsupported controlled-controlled gate: {gate!r}")
    operand = {"a": str(control1), "b": str(control2), "c": str(target)}
    suffix = f"[{tag}]" if tag else ""
    body = [
        f"{name}{suffix} " + " ".join(operand[x] for x in ops)
        for name, ops in _CCZ_SEQUENCE
    ]
    if gate == "CCX":
        h_line = f"H{suffix} {operand['c']}"
        body = [h_line, *body, h_line]
    return body


def _expand_controlled_gates(text: str) -> str:
    """Expand every CCZ/CCX line (3k targets each) into Clifford+T lines."""
    ccx_line = re.compile(r"^(\s*)(CCZ|CCX)(?:\[([^\]\n]*)\])?\s+(.+?)\s*$")
    out: list[str] = []
    for line in text.splitlines():
        body, hash_sep, comment = line.partition("#")
        m = ccx_line.match(body)
        if m is None:
            out.append(line)
            continue
        indent, gate, tag, rest = m.groups()
        qubits = rest.split()
        if len(qubits) % 3 != 0 or not all(q.isdecimal() for q in qubits):
            raise ValueError(
                f"{gate} expects bare qubit integer targets in groups of three."
            )
        if hash_sep:
            out.append(f"{indent}{hash_sep}{comment}")
        for a, b, c in zip(qubits[0::3], qubits[1::3], qubits[2::3]):
            out += [
                indent + dl
                for dl in controlled_gate_decomposition_lines(
                    gate, a, b, c, tag=tag or ""
                )
            ]
    return "\n".join(out)


def enriched_stim_error(exc: ValueError, converted_text: str) -> ValueError:
    """Point 'Gate not found' errors at the unconverted shorthand usage."""
    hit = _GATE_NOT_FOUND_RE.search(str(exc))
    if hit is None or hit.group(1) not in _TSIM_GATES:
        return exc
    usage = _GATE_USAGE_RE.search(converted_text)
    if usage is None:
        return exc
    return ValueError(f"Could not parse '{usage.group()}' in program text.")


def format_angle(x) -> str:
    """Display form of an angle (units of pi) parsed into a canonical dyadic.

    Angles canonicalize to 2^-40 resolution at parse time
    (``core.parse.canonical_angle``); 12 significant digits collapse the
    dyadic back to the user's decimal (0.300000000000182 -> "0.3"), and
    re-parsing the display form recovers the identical canonical dyadic for
    any user input with at most 12 significant digits.
    """
    return f"{float(x):.12g}"


# --- rewrite handlers (forward: shorthand -> stim) --------------------------


def _fwd_same_axis_pair(m: re.Match) -> str:
    axis, alpha, q0, q1 = m.groups()
    if q0 == q1:
        raise ValueError(
            f"R_{axis}{axis} target qubits must be distinct, got {q0} {q1}."
        )
    return f"SPP[R_PAULI(theta={float(alpha)}*pi)] {axis}{q0}*{axis}{q1}"


def _fwd_r_pauli(m: re.Match) -> str:
    return f"SPP[R_PAULI(theta={float(m.group(1))}*pi)] {m.group(2)}"


def _fwd_rotation(m: re.Match) -> str:
    return f"I[R_{m.group(1)}(theta={float(m.group(2))}*pi)]"


def _fwd_u3(m: re.Match) -> str:
    th, ph, la = (float(m.group(k)) for k in (1, 2, 3))
    return f"I[U3(theta={th}*pi, phi={ph}*pi, lambda={la}*pi)]"


def _fwd_canonical_literal(m: re.Match) -> str:
    # Equal angles in different notations (0.5e-2 vs 0.005) must produce the
    # same tag string, or round-trip equality across notations breaks.
    return f"{m.group(1)}={float(m.group(2))}*pi"


# --- rewrite handlers (backward: stim -> shorthand) --------------------------


def _bwd_u3(m: re.Match) -> str:
    return f"U3({m.group(1)}, {m.group(2)}, {m.group(3)})"


def _bwd_same_axis_pair(m: re.Match) -> str:
    alpha, axis, q0, q1 = m.groups()
    return f"R_{axis}{axis}({alpha}) {q0} {q1}"


def _bwd_r_pauli(m: re.Match) -> str:
    return f"R_PAULI({m.group(1)}) {m.group(2)}"


def _bwd_rotation(m: re.Match) -> str:
    return f"R_{m.group(1)}({m.group(2)})"


def _rule_table(pairs):
    return tuple((re.compile(pat), fn) for pat, fn in pairs)


def _t_encode(stim_name: str):
    def sub(m: re.Match) -> str:
        return f"{stim_name}[{encode_t_tag(m.group(1) or '')}]"

    return sub


def _t_decode(shorthand_name: str):
    def sub(m: re.Match) -> str:
        user = decode_t_user_tag(m.group(1))
        return f"{shorthand_name}[{user}]" if user else shorthand_name

    return sub


# Ordered rule tables, compiled once at import. Order matters twice: the
# T family is ordered longest-name-first (see _T_FAMILY), and the same-axis
# pair rule must run before the generic R_PAULI rule in both directions.
_FORWARD_RULES = _rule_table(
    [
        (rf"(?<!\[)\b{sh}(?:\[([^\]\n]*)\])?(?!\w)", _t_encode(st))
        for sh, st in _T_FAMILY
    ]
    + [
        (rf"\bR_([XYZ])\1\(({FLOAT_RE})\)\s+(\d+)\s+(\d+)", _fwd_same_axis_pair),
        (rf"\bR_PAULI\(({FLOAT_RE})\)\s+((?:[XYZ]\d+)(?:\*[XYZ]\d+)*)", _fwd_r_pauli),
        (rf"\bR_([XYZ])\(({FLOAT_RE})\)", _fwd_rotation),
        (
            rf"\bU3\(({FLOAT_RE})\s*,\s*({FLOAT_RE})\s*,\s*({FLOAT_RE})\)",
            _fwd_u3,
        ),
        (rf"\b(theta|phi|lambda)=({FLOAT_RE})\*pi", _fwd_canonical_literal),
    ]
)

_BACKWARD_RULES = _rule_table(
    [
        (
            rf"\bI\[U3\(theta=({FLOAT_RE})\*pi, phi=({FLOAT_RE})\*pi,"
            rf" lambda=({FLOAT_RE})\*pi\)\]",
            _bwd_u3,
        ),
        (
            rf"\bSPP\[R_PAULI\(theta=({FLOAT_RE})\*pi\)\]"
            rf" ([XYZ])(\d+)\*\2(\d+)(?!\*)\b",
            _bwd_same_axis_pair,
        ),
        (
            rf"\bSPP\[R_PAULI\(theta=({FLOAT_RE})\*pi\)\]"
            rf" ((?:[XYZ]\d+)(?:\*[XYZ]\d+)*)",
            _bwd_r_pauli,
        ),
        (rf"\bI\[R_([XYZ])\(theta=({FLOAT_RE})\*pi\)\]", _bwd_rotation),
    ]
    + [
        (rf"(?<!\w){st}\[(T(?::[^\]\n]*)?)\](?!\w)", _t_decode(sh))
        for sh, st in _T_FAMILY
    ]
)


def shorthand_to_stim(text: str) -> str:
    """Convert tsim shorthand to valid Stim-dialect instructions."""
    text = _expand_controlled_gates(text)
    for pattern, handler in _FORWARD_RULES:
        text = pattern.sub(handler, text)
    return text


def stim_to_shorthand(text: str) -> str:
    """Convert expanded Stim annotations back to tsim shorthand."""
    for pattern, handler in _BACKWARD_RULES:
        text = pattern.sub(handler, text)
    return text
