"""Rotated surface code memory circuit generator.

Generates memory-Z experiments on the rotated [[d^2, 1, d]] surface code
(equivalent workload family to ``stim.Circuit.generated("surface_code:
rotated_memory_z")`` used by the reference benchmarks). Layout: d x d data
grid; interior 4-body plaquettes on a checkerboard (Z when (i+j) even),
X-type 2-body half-plaquettes on the top/bottom boundary, Z-type on
left/right. Logical Z = top row. Detector determinism is verified against
the statevector oracle in tests.
"""

from __future__ import annotations

from ..circuit import Circuit


def _build_stabilizers(d: int):
    """Returns (z_stabs, x_stabs): lists of data-qubit (i, j) tuples."""
    z_stabs: list[list[tuple[int, int]]] = []
    x_stabs: list[list[tuple[int, int]]] = []
    for i in range(d - 1):
        for j in range(d - 1):
            quad = [(i, j), (i, j + 1), (i + 1, j), (i + 1, j + 1)]
            (z_stabs if (i + j) % 2 == 0 else x_stabs).append(quad)
    for j in range(d - 1):  # top (i = -1) and bottom (i = d-1) X boundaries
        if (-1 + j) % 2 == 1:
            x_stabs.append([(0, j), (0, j + 1)])
        if (d - 1 + j) % 2 == 1:
            x_stabs.append([(d - 1, j), (d - 1, j + 1)])
    for i in range(d - 1):  # left (j = -1) and right (j = d-1) Z boundaries
        if (i - 1) % 2 == 0:
            z_stabs.append([(i, 0), (i + 1, 0)])
        if (i + d - 1) % 2 == 0:
            z_stabs.append([(i, d - 1), (i + 1, d - 1)])
    return z_stabs, x_stabs


def rotated_surface_code_memory_z(
    distance: int,
    rounds: int,
    *,
    after_clifford_depolarization: float = 0.0,
    before_round_data_depolarization: float = 0.0,
    before_measure_flip_probability: float = 0.0,
    after_reset_flip_probability: float = 0.0,
    pauli_channel_1: tuple[float, float, float] | None = None,
    pauli_channel_2: tuple[float, ...] | None = None,
    basis: str = "Z",
) -> Circuit:
    """Memory experiment: reset, ``rounds`` stabilizer rounds, data readout.

    ``basis="Z"`` (default) prepares/measures data in Z; ``basis="X"``
    conjugates the whole experiment by transversal H (memory-X: |+> init,
    X-basis readout, detectors on the X-type stabilizers, logical X).

    ``pauli_channel_1`` (px, py, pz) replaces the per-round data
    depolarization with a biased single-qubit Pauli channel, and
    ``pauli_channel_2`` (15 probabilities, stim argument order) replaces
    the two-qubit depolarization after each CX — the BASELINE.md
    workload-2 noise model (surface-code memory with PAULI_CHANNEL_1/2).
    """
    d = distance
    if d < 2 or rounds < 1:
        raise ValueError("distance >= 2 and rounds >= 1 required")
    z_stabs, x_stabs = _build_stabilizers(d)
    data_index = {(i, j): i * d + j for i in range(d) for j in range(d)}
    n_data = d * d
    z_anc = {k: n_data + k for k in range(len(z_stabs))}
    x_anc = {k: n_data + len(z_stabs) + k for k in range(len(x_stabs))}
    n_anc = len(z_stabs) + len(x_stabs)

    p_cx = after_clifford_depolarization
    p_data = before_round_data_depolarization
    p_m = before_measure_flip_probability
    p_r = after_reset_flip_probability

    lines: list[str] = []
    all_data = " ".join(str(q) for q in range(n_data))
    all_anc = " ".join(str(n_data + a) for a in range(n_anc))
    x_anc_str = " ".join(str(x_anc[k]) for k in range(len(x_stabs)))

    if basis not in ("Z", "X"):
        raise ValueError(f"basis must be 'Z' or 'X', got {basis!r}")
    data_init = "R" if basis == "Z" else "RX"
    lines.append(f"{data_init} {all_data}")
    lines.append(f"R {all_anc}")
    if p_r:
        err = "X_ERROR" if basis == "Z" else "Z_ERROR"
        lines.append(f"{err}({p_r}) {all_data}")
        lines.append(f"X_ERROR({p_r}) {all_anc}")
    lines.append("TICK")

    # Interaction schedule: each stabilizer touches its data qubits in a
    # fixed local order over 4 steps (2 steps for boundary stabilizers).
    pc1 = (
        "PAULI_CHANNEL_1(" + ", ".join(str(x) for x in pauli_channel_1) + ")"
        if pauli_channel_1 is not None and any(pauli_channel_1)
        else None
    )
    pc2 = (
        "PAULI_CHANNEL_2(" + ", ".join(str(x) for x in pauli_channel_2) + ")"
        if pauli_channel_2 is not None and any(pauli_channel_2)
        else None
    )

    def _round(first: bool) -> None:
        if pc1:
            lines.append(f"{pc1} {all_data}")
        if p_data:
            lines.append(f"DEPOLARIZE1({p_data}) {all_data}")
        lines.append(f"H {x_anc_str}")
        if p_cx:
            lines.append(f"DEPOLARIZE1({p_cx}) {x_anc_str}")
        lines.append("TICK")
        for step in range(4):
            pairs = []
            for k, quad in enumerate(z_stabs):
                if step < len(quad):
                    dq = data_index[quad[step]]
                    pairs.append((dq, z_anc[k]))  # data controls Z-ancilla
            for k, quad in enumerate(x_stabs):
                if step < len(quad):
                    dq = data_index[quad[step]]
                    pairs.append((x_anc[k], dq))  # X-ancilla controls data
            if not pairs:
                continue
            tgt = " ".join(f"{a} {b}" for a, b in pairs)
            lines.append(f"CX {tgt}")
            if pc2:
                lines.append(f"{pc2} {tgt}")
            if p_cx:
                lines.append(f"DEPOLARIZE2({p_cx}) {tgt}")
            lines.append("TICK")
        lines.append(f"H {x_anc_str}")
        if p_cx:
            lines.append(f"DEPOLARIZE1({p_cx}) {x_anc_str}")
        lines.append("TICK")
        if p_m:
            lines.append(f"X_ERROR({p_m}) {all_anc}")
        lines.append(f"MR {all_anc}")
        if p_r:
            lines.append(f"X_ERROR({p_r}) {all_anc}")
        # Detectors: ancillas were measured in order z..., x... In the
        # first round only the init-basis stabilizers are deterministic.
        for k in range(len(z_stabs)):
            back = -(n_anc - k)
            if first:
                if basis == "Z":
                    lines.append(f"DETECTOR rec[{back}]")
            else:
                lines.append(f"DETECTOR rec[{back}] rec[{back - n_anc}]")
        for k in range(len(x_stabs)):
            back = -(len(x_stabs) - k)
            if first:
                if basis == "X":
                    lines.append(f"DETECTOR rec[{back}]")
            else:
                lines.append(f"DETECTOR rec[{back}] rec[{back - n_anc}]")

    _round(first=True)
    for _ in range(rounds - 1):
        _round(first=False)

    if p_m:
        err = "X_ERROR" if basis == "Z" else "Z_ERROR"
        lines.append(f"{err}({p_m}) {all_data}")
    lines.append(("M" if basis == "Z" else "MX") + f" {all_data}")
    # Final detectors: init-basis stabilizer supports + last ancilla rec.
    final_stabs = z_stabs if basis == "Z" else x_stabs
    anc_of = (lambda k: k) if basis == "Z" else (lambda k: len(z_stabs) + k)
    for k, quad in enumerate(final_stabs):
        recs = [-(n_data - data_index[q]) for q in quad]
        anc_back = -(n_data + n_anc - anc_of(k))
        recs_s = " ".join(f"rec[{r}]" for r in recs)
        lines.append(f"DETECTOR {recs_s} rec[{anc_back}]")
    if basis == "Z":
        support = [(0, j) for j in range(d)]   # logical Z: top row
    else:
        support = [(i, 0) for i in range(d)]   # logical X: left column
    obs = " ".join(f"rec[{-(n_data - data_index[q])}]" for q in support)
    lines.append(f"OBSERVABLE_INCLUDE(0) {obs}")

    return Circuit("\n".join(lines))


def generated(name: str, **kwargs) -> Circuit:
    """Stim-style generated-circuit interface.

    Supports ``"surface_code:rotated_memory_z"`` and
    ``"surface_code:rotated_memory_x"`` with the same noise keyword
    arguments stim uses (reference workloads construct their benchmark
    circuits through ``stim.Circuit.generated``).
    """
    table = {
        "surface_code:rotated_memory_z": "Z",
        "surface_code:rotated_memory_x": "X",
    }
    if name not in table:
        raise ValueError(
            f"Unsupported generated circuit {name!r}; supported: {sorted(table)}"
        )
    return rotated_surface_code_memory_z(
        kwargs.pop("distance"), kwargs.pop("rounds"), basis=table[name], **kwargs
    )
