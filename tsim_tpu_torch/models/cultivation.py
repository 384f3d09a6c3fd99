"""Magic state cultivation benchmark circuits.

Cultivation (Gidney-Shutty-Jones style; the reference benchmarks a "d=3
cultivation (1024 stabilizer terms)" workload, reference
``docs/benchmarks.svg`` panel 3 and ``README.md:98``) grows a |H_XY> magic
state on a small color code by repeatedly *checking* it: measuring the
logical H_XY = (X+Y)/sqrt(2) Clifford with an ancilla-controlled transversal
application, post-selecting on the +1 outcome, interleaved with stabilizer
measurements.

This generator produces a simulation-benchmark version on the [[7,1,3]]
color (Steane) code: the ancilla is a bare qubit (the simulation workload —
T-count, graph structure — matches the fault-tolerant version; the cat
ancilla expansion only adds Cliffords). Each controlled-H_XY uses

    C-HXY(a, q) = (I (x) W+) CZ(a, q) (I (x) W),   W = H RZ(-pi/4)

i.e. ``T_DAG q; H q; CZ a q; H q; T q`` — exactly 2 T gates per data qubit
per check, so a k-check d=3 cultivation carries 1 + 14k T gates.

Validated against the statevector oracle in
``tests/integration/test_cultivation.py``: all detectors are deterministic
zero on the noiseless circuit and the logical X observable has mean
(1 - 1/sqrt(2))/2.
"""

from __future__ import annotations

from ..circuit import Circuit
from ..utils.encoder import SteaneEncoder

# [[7,1,3]] self-dual CSS generators / logical support (matches the
# SteaneEncoder layout in utils/encoder.py).
_STABS = [[0, 1, 2, 3], [1, 2, 4, 5], [2, 3, 4, 6]]
_LOGICAL = [0, 1, 5]
_N = 7
_ANCILLA = 7


def _check_round(noise: float) -> list[str]:
    """One H_XY check: ancilla |+>, transversal C-HXY, MX ancilla."""
    lines = [f"RX {_ANCILLA}"]
    if noise:
        lines.append(f"Z_ERROR({noise}) {_ANCILLA}")
    for q in range(_N):
        lines.append(f"T_DAG {q}")
        lines.append(f"H {q}")
        lines.append(f"CZ {_ANCILLA} {q}")
        if noise:
            lines.append(f"DEPOLARIZE2({noise}) {_ANCILLA} {q}")
        lines.append(f"H {q}")
        lines.append(f"T {q}")
    # Transversal H_XY on the [[7,1,3]] code implements Z_L * H_XY,L (the
    # weight-3 logical Y picks up a sign: Y^(x)3 = -Y_L); a controlled-Z_L
    # correction makes the ancilla measure logical H_XY exactly.
    for q in _LOGICAL:
        lines.append(f"CZ {_ANCILLA} {q}")
        if noise:
            lines.append(f"DEPOLARIZE2({noise}) {_ANCILLA} {q}")
    # The controlled transversal picks up a global phase i on the target
    # unitary (C-(i V) kicks the ancilla by S): undo it so the +1 outcome
    # maps to measurement result 0.
    lines.append(f"S_DAG {_ANCILLA}")
    if noise:
        lines.append(f"Z_ERROR({noise}) {_ANCILLA}")
    lines.append(f"MX {_ANCILLA}")
    lines.append("DETECTOR rec[-1]")
    return lines


def _stabilizer_round(noise: float) -> list[str]:
    """Measure all X- and Z-type stabilizer generators via MPP."""
    lines = []
    for basis in ("X", "Z"):
        for gen in _STABS:
            prod = "*".join(f"{basis}{q}" for q in gen)
            if noise:
                lines.append(f"MPP({noise}) {prod}")
            else:
                lines.append(f"MPP {prod}")
            lines.append("DETECTOR rec[-1]")
    return lines


def cultivation_logical(
    p: float = 0.001, checks: int = 1, noise: float | None = None
) -> Circuit:
    """Unencoded (single-qubit) cultivation: inject |H_XY>, check, read out.

    The logical-level workload (T-count 1 + 2 * checks): data qubit 0 holds
    |H_XY> = T|+>, each check measures H_XY via an ancilla-controlled
    C-HXY(1, 0); the X-basis readout observable has mean (1 - 1/sqrt(2))/2.
    Small enough for statevector-oracle integration tests.
    """
    noise = p / 10 if noise is None else noise
    lines = ["R 0", "H 0", "T 0"]
    if p:
        lines.append(f"DEPOLARIZE1({p}) 0")
    for _ in range(checks):
        lines.append("RX 1")
        lines.append("T_DAG 0")
        lines.append("H 0")
        lines.append("CZ 1 0")
        if noise:
            lines.append(f"DEPOLARIZE2({noise}) 1 0")
        lines.append("H 0")
        lines.append("T 0")
        lines.append("MX 1")
        lines.append("DETECTOR rec[-1]")
    lines.append("MX 0")
    lines.append("OBSERVABLE_INCLUDE(0) rec[-1]")
    return Circuit("\n".join(lines))


# --- Full-protocol d=3 cultivation: cat checks + grow to [[17,1,5]] --------
#
# Layout for ``cultivation_d3_grown``: the d=3 color code lives on qubits
# 10..16 of the [[17,1,5]] d=5 color code (utils/encoder.py ColorEncoder5),
# whose corner faces (11,13,14,16), (10,11,12,14), (12,14,15,16) form a
# [[7,1,3]] block with logical support (10,12,15). The Steane encoding
# circuit maps onto that block under the qubit permutation below (found by
# exhaustive search over Fano-plane relabelings: every Steane face maps
# into the block-face group and the logical line (0,1,5) maps to (0,2,5)).
_BLOCK_PERM = (0, 2, 1, 4, 3, 5, 6)  # steane index -> block-local index
_BLOCK_BASE = 10
_D5_FACES = [
    (0, 1, 2, 3),
    (0, 2, 4, 5),
    (4, 5, 6, 7),
    (6, 7, 8, 9),
    (11, 13, 14, 16),
    (10, 11, 12, 14),
    (12, 14, 15, 16),
    (2, 3, 5, 6, 8, 10, 11, 13),
]
_BLOCK_FACES = [(11, 13, 14, 16), (10, 11, 12, 14), (12, 14, 15, 16)]
_D5_LOGICAL = (1, 3, 10, 12, 15)
_BLOCK_LOGICAL = (10, 12, 15)
# Fresh d=5 qubits 0..9: |+> on the fresh part of the logical support so
# X_L(d5) = X_L(d3) x X_fresh carries the cultivated value; |0> elsewhere
# so three of the four fresh-only Z faces start deterministic.
_FRESH_PLUS = (1, 3)
_FRESH_ZERO = (0, 2, 4, 5, 6, 7, 8, 9)
# Cat-check ancillas: root + 3 legs, each leg controlling ~2 data qubits.
_CAT_ROOT = 17
_CAT_LEGS = (18, 19, 20)
_LEG_DATA = {17: (10, 11), 18: (12, 13), 19: (14, 15), 20: (16,)}
# Logical-correction CZs (C-Z_L): routed through the leg nearest each
# logical-support qubit.
_LEG_LOGICAL = {17: (10,), 18: (12,), 19: (15,), 20: ()}


def _mpp_round(faces, noise: float, bases=("X", "Z")) -> list[str]:
    lines = []
    for basis in bases:
        for gen in faces:
            prod = "*".join(f"{basis}{q}" for q in gen)
            lines.append(f"MPP({noise}) {prod}" if noise else f"MPP {prod}")
    return lines


def _cat_check_round(noise: float) -> list[str]:
    """One fault-tolerant H_XY check: cat-expanded ancilla, transversal
    C-HXY, logical-Z correction, un-expansion, leg verification.

    The root ancilla |+> is expanded into a 4-qubit cat state via a CX
    ladder; each leg applies the controlled W = H RZ(-pi/4) conjugation
    (``T_DAG q; H q; CZ leg q; H q; T q``) to its assigned data qubits, so
    the product over legs equals the single-ancilla controlled transversal
    H_XY exactly. After un-expansion the legs return to |0> (deterministic
    detectors) and the root measures the logical H_XY eigenvalue in X.
    """
    legs = (_CAT_ROOT,) + _CAT_LEGS
    lines = [f"RX {_CAT_ROOT}", "R " + " ".join(str(a) for a in _CAT_LEGS)]
    if noise:
        lines.append(f"Z_ERROR({noise}) {_CAT_ROOT}")
    for leg in _CAT_LEGS:
        lines.append(f"CX {_CAT_ROOT} {leg}")
        if noise:
            lines.append(f"DEPOLARIZE2({noise}) {_CAT_ROOT} {leg}")
    for leg in legs:
        for q in _LEG_DATA[leg]:
            lines.append(f"T_DAG {q}")
            lines.append(f"H {q}")
            lines.append(f"CZ {leg} {q}")
            if noise:
                lines.append(f"DEPOLARIZE2({noise}) {leg} {q}")
            lines.append(f"H {q}")
            lines.append(f"T {q}")
    # Weight-3 logical Y picks up a sign under the transversal map
    # (Y^(x)3 = -Y_L): a controlled-Z_L correction, distributed over legs.
    for leg in legs:
        for q in _LEG_LOGICAL[leg]:
            lines.append(f"CZ {leg} {q}")
            if noise:
                lines.append(f"DEPOLARIZE2({noise}) {leg} {q}")
    for leg in _CAT_LEGS:
        lines.append(f"CX {_CAT_ROOT} {leg}")
        if noise:
            lines.append(f"DEPOLARIZE2({noise}) {_CAT_ROOT} {leg}")
    # Legs must return to |0>: verification detectors catch cat errors.
    for leg in _CAT_LEGS:
        if noise:
            lines.append(f"X_ERROR({noise}) {leg}")
        lines.append(f"M {leg}")
        lines.append("DETECTOR rec[-1]")
    # Global-phase fix: C-(i V) kicks the control by S, undo on the root.
    lines.append(f"S_DAG {_CAT_ROOT}")
    if noise:
        lines.append(f"Z_ERROR({noise}) {_CAT_ROOT}")
    lines.append(f"MX {_CAT_ROOT}")
    lines.append("DETECTOR rec[-1]")
    return lines


def cultivation_d3_grown(
    p: float = 0.001,
    checks: int = 2,
    noise: float | None = None,
) -> Circuit:
    """Full-protocol d=3 cultivation benchmark (reference panel 3 scale).

    The complete Gidney-Shutty-Jones pipeline (arXiv:2409.17595 semantics;
    reference ``docs/benchmarks.svg`` panel 3 "d=3 cultivation (1024
    stabilizer terms)", ``README.md:98``): inject T|+> into the d=3 color
    code, run ``checks`` cat-ancilla H_XY check rounds each followed by a
    stabilizer round, grow to the [[17,1,5]] d=5 color code by measuring
    the d=5 faces (fresh qubits |0>/|+> per ``_FRESH_PLUS``), re-measure,
    and read out transversally in X. 21 qubits, T-count 1 + 14 * checks.

    Detector schedule: d=3-stage checks/legs/stabilizers and the grow
    round-1 faces that are noiselessly deterministic get absolute
    detectors; random-first-outcome faces get round-2 comparison detectors;
    the readout compares data parities against the round-2 X faces.
    """
    noise = p / 10 if noise is None else noise

    # -- injection + encoding on the block (Steane encoder, permuted) -----
    encoder = SteaneEncoder()
    inject = "R 0\nH 0\nT 0\n"
    if p:
        inject += f"DEPOLARIZE1({p}) 0\n"
    encoder.initialize(inject)
    block_text = _relabel_qubits(
        str(encoder.circuit),
        {i: _BLOCK_BASE + _BLOCK_PERM[i] for i in range(7)},
    )
    lines = [block_text]

    # -- cultivation stage: cat checks + block stabilizer rounds ----------
    for _ in range(checks):
        lines.extend(_cat_check_round(noise))
        lines.extend(_mpp_round(_BLOCK_FACES, noise))
        lines.extend(f"DETECTOR rec[{k - 6}]" for k in range(6))

    # -- grow: init fresh qubits, measure all d=5 faces twice -------------
    lines.append("R " + " ".join(str(q) for q in _FRESH_ZERO))
    lines.append("RX " + " ".join(str(q) for q in _FRESH_PLUS))
    if noise:
        lines.append(
            f"DEPOLARIZE1({noise}) " + " ".join(str(q) for q in range(10))
        )
    # Round 1: X faces then Z faces (16 measurements, oldest first).
    lines.extend(_mpp_round(_D5_FACES, noise))
    # Deterministic round-1 detectors: the three block faces (code space)
    # in both bases, and the fresh-only Z faces whose qubits all start |0>.
    det_round1 = {
        ("X", f) for f in _BLOCK_FACES
    } | {("Z", f) for f in _BLOCK_FACES} | {
        ("Z", f)
        for f in [(0, 2, 4, 5), (4, 5, 6, 7), (6, 7, 8, 9)]
    }
    order = [("X", f) for f in _D5_FACES] + [("Z", f) for f in _D5_FACES]
    for k, key in enumerate(order):
        if key in det_round1:
            lines.append(f"DETECTOR rec[{k - len(order)}]")
    # Round 2: every face compares against its round-1 partner.
    lines.extend(_mpp_round(_D5_FACES, noise))
    n = len(order)
    for k in range(n):
        lines.append(f"DETECTOR rec[{k - n}] rec[{k - 2 * n}]")

    # -- transversal X readout on the d=5 code ----------------------------
    if noise:
        lines.append(
            f"Z_ERROR({noise}) " + " ".join(str(q) for q in range(17))
        )
    lines.append("MX " + " ".join(str(q) for q in range(17)))
    # Data parities must reproduce the round-2 X-face outcomes.
    for fi, face in enumerate(_D5_FACES):
        recs = " ".join(f"rec[{q - 17}]" for q in face)
        lines.append(f"DETECTOR {recs} rec[{fi - 2 * n - 17}]")
    obs = " ".join(f"rec[{q - 17}]" for q in _D5_LOGICAL)
    lines.append(f"OBSERVABLE_INCLUDE(0) {obs}")

    return Circuit("\n".join(lines))


def _relabel_qubits(program_text: str, mapping: dict[int, int]) -> str:
    """Rewrite plain-integer qubit targets in a stim program text.

    Only bare integer target tokens are touched; the instruction head
    (name + parens args), rec[...] lookbacks, and annotation lines pass
    through unchanged.
    """
    out_lines = []
    for line in program_text.splitlines():
        stripped = line.strip()
        if not stripped:
            continue
        name = stripped.split("(")[0].split()[0]
        if name in ("DETECTOR", "OBSERVABLE_INCLUDE", "SHIFT_COORDS"):
            out_lines.append(stripped)
            continue
        tokens = stripped.split()
        head = [tokens[0]]
        rest = tokens[1:]
        # Parens args may be split across tokens, e.g. "X_ERROR(0.1)".
        while head[-1].count("(") > head[-1].count(")") and rest:
            head.append(rest.pop(0))
        body = []
        for t in rest:
            if t.isdigit():
                body.append(str(mapping.get(int(t), int(t))))
            elif t.lstrip("!")[:1] in "XYZ":
                # Pauli-product atoms (MPP targets), e.g. "X11*Z13*!Y16".
                atoms = []
                for a in t.split("*"):
                    sign = "!" if a.startswith("!") else ""
                    basis = a[len(sign) : len(sign) + 1]
                    tail = a[len(sign) + 1 :]
                    if basis not in "XYZ" or not tail.isdigit():
                        atoms = None
                        break
                    atoms.append(f"{sign}{basis}{mapping.get(int(tail), int(tail))}")
                body.append("*".join(atoms) if atoms is not None else t)
            else:
                body.append(t)
        out_lines.append(" ".join(head + body))
    return "\n".join(out_lines)


def cultivation_d3(
    p: float = 0.001,
    checks: int = 1,
    stabilizer_rounds: int = 1,
    noise: float | None = None,
) -> Circuit:
    """d=3 cultivation benchmark: inject |H_XY>, check ``checks`` times.

    Args:
        p: injection depolarizing noise.
        checks: number of H_XY check rounds (T-count 1 + 14 * checks).
        stabilizer_rounds: MPP stabilizer-measurement rounds after checks.
        noise: gate noise inside checks/stabilizer rounds (default p / 10).
    """
    noise = p / 10 if noise is None else noise

    encoder = SteaneEncoder()
    inject = "R 0\nH 0\nT 0\n"
    if p:
        inject += f"DEPOLARIZE1({p}) 0\n"
    encoder.initialize(inject)
    lines = [str(encoder.circuit)]

    for _ in range(checks):
        lines.extend(_check_round(noise))
    for _ in range(stabilizer_rounds):
        lines.extend(_stabilizer_round(noise))

    # Destructive transversal X-basis readout: stabilizer detectors from
    # data bits plus the logical X observable (<X_L> = 1/sqrt(2) on |H_XY>).
    if noise:
        lines.append(f"Z_ERROR({noise}) " + " ".join(str(q) for q in range(_N)))
    lines.append("MX " + " ".join(str(q) for q in range(_N)))
    for gen in _STABS:
        recs = " ".join(f"rec[{q - _N}]" for q in gen)
        lines.append(f"DETECTOR {recs}")
    obs = " ".join(f"rec[{q - _N}]" for q in _LOGICAL)
    lines.append(f"OBSERVABLE_INCLUDE(0) {obs}")

    return Circuit("\n".join(lines))
