"""Circuit and ZX diagram rendering (SVG).

Covers the reference's diagram surface (reference ``tsim/utils/diagram.py``):
timeline SVGs with tsim gate labels (T, TPP, rotations), timeslice views,
and ZX-graph SVG rendering. Implemented as a self-contained SVG writer (no
external renderer dependency).
"""

from __future__ import annotations

import html
from fractions import Fraction

from ..core.parse import parse_parametric_tag
from ..core.tags import is_t_tag
from ..stim_core.instruction import CircuitInstruction, CircuitRepeatBlock


class Diagram:
    """SVG wrapper: str() yields raw SVG; notebooks render inline."""

    def __init__(self, svg: str):
        self._svg = svg

    def __str__(self) -> str:
        return self._svg

    def _repr_html_(self) -> str:
        return self._svg


_GATE_LABELS = {
    "S_DAG": "S†", "SQRT_X": "√X", "SQRT_X_DAG": "√X†",
    "SQRT_Y": "√Y", "SQRT_Y_DAG": "√Y†",
    "SQRT_Z": "S", "SQRT_Z_DAG": "S†",
}


def _instr_label(instr: CircuitInstruction) -> str:
    name = instr.name
    if name in ("S", "S_DAG") and is_t_tag(instr.tag):
        return "T" if name == "S" else "T†"
    if name in ("SPP", "SPP_DAG") and is_t_tag(instr.tag):
        return "TPP" if name == "SPP" else "TPP†"
    if instr.tag:
        parsed = None
        try:
            parsed = parse_parametric_tag(instr)
        except ValueError:
            pass
        if parsed is not None:
            gate, params = parsed
            if gate == "U3":
                vals = ", ".join(f"{float(params[k]):.3g}" for k in ("theta", "phi", "lambda"))
                return f"U3({vals})"
            return f"{gate}({float(params['theta']):.3g})"
    return _GATE_LABELS.get(name, name)


def render_timeline_svg(
    circuit,
    *,
    width: float | None = None,
    height: float | None = None,
) -> Diagram:
    """Column-per-instruction timeline SVG of a (flattened) circuit."""
    flat = circuit.flattened() if hasattr(circuit, "flattened") else circuit
    nq = max(flat.num_qubits, 1)
    col_w, row_h, pad = 64, 36, 40
    cols: list[tuple[CircuitInstruction, list[list[int]]]] = []
    for instr in flat:
        if isinstance(instr, CircuitRepeatBlock):
            continue
        groups = [
            [t.value for t in grp if t.is_qubit_target or t.is_pauli_target]
            for grp in instr.target_groups()
        ]
        cols.append((instr, groups))

    w = pad * 2 + col_w * max(len(cols), 1)
    h = pad * 2 + row_h * nq
    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width or w}" '
        f'height="{height or h}" viewBox="0 0 {w} {h}" font-family="monospace">'
    ]
    for q in range(nq):
        y = pad + q * row_h + row_h / 2
        parts.append(
            f'<line x1="{pad}" y1="{y}" x2="{w - pad}" y2="{y}" stroke="#888"/>'
        )
        parts.append(f'<text x="4" y="{y + 4}" font-size="11">q{q}</text>')
    mcount = 0
    for ci, (instr, groups) in enumerate(cols):
        x = pad + ci * col_w + col_w / 2
        label = _instr_label(instr)
        if instr.name in ("DETECTOR", "OBSERVABLE_INCLUDE", "TICK", "SHIFT_COORDS",
                          "QUBIT_COORDS", "MPAD"):
            parts.append(
                f'<text x="{x}" y="{pad - 14}" font-size="9" text-anchor="middle" '
                f'fill="#a33">{html.escape(label)}</text>'
            )
            continue
        for grp in groups:
            if not grp:
                continue
            ys = [pad + q * row_h + row_h / 2 for q in grp]
            if len(ys) > 1:
                parts.append(
                    f'<line x1="{x}" y1="{min(ys)}" x2="{x}" y2="{max(ys)}" '
                    f'stroke="#333"/>'
                )
            for q, y in zip(grp, ys):
                txt = html.escape(label if len(grp) == 1 else label[:4])
                parts.append(
                    f'<rect x="{x - 24}" y="{y - 12}" width="48" height="24" '
                    f'fill="#fff" stroke="#333" rx="3"/>'
                    f'<text x="{x}" y="{y + 4}" font-size="10" '
                    f'text-anchor="middle">{txt}</text>'
                )
        if instr.num_measurements:
            for k in range(instr.num_measurements):
                parts.append(
                    f'<text x="{x}" y="{h - 8}" font-size="8" text-anchor="middle" '
                    f'fill="#36c">rec[{mcount + k}]</text>'
                )
            mcount += instr.num_measurements
    parts.append("</svg>")
    return Diagram("".join(parts))


def render_timeslice_svg(
    circuit,
    *,
    width: float | None = None,
    height: float | None = None,
) -> Diagram:
    """One panel per TICK-delimited slice, qubits on a 2D-ish grid."""
    flat = circuit.flattened() if hasattr(circuit, "flattened") else circuit
    nq = max(flat.num_qubits, 1)
    slices: list[list[tuple[CircuitInstruction, list[list[int]]]]] = [[]]
    for instr in flat:
        if isinstance(instr, CircuitRepeatBlock):
            continue
        if instr.name == "TICK":
            slices.append([])
            continue
        groups = [
            [t.value for t in grp if t.is_qubit_target or t.is_pauli_target]
            for grp in instr.target_groups()
        ]
        slices[-1].append((instr, groups))
    slices = [s for s in slices if s] or [[]]

    row_h, panel_w, pad = 30, 190, 28
    h = pad * 2 + row_h * nq
    w = pad + (panel_w + pad) * len(slices)
    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width or w}" '
        f'height="{height or h}" viewBox="0 0 {w} {h}" font-family="monospace">'
    ]
    for si, ops in enumerate(slices):
        x0 = pad + si * (panel_w + pad)
        parts.append(
            f'<rect x="{x0}" y="{pad - 16}" width="{panel_w}" '
            f'height="{h - 2 * pad + 24}" fill="none" stroke="#bbb"/>'
            f'<text x="{x0 + 4}" y="{pad - 4}" font-size="10" '
            f'fill="#777">tick {si}</text>'
        )
        for q in range(nq):
            y = pad + q * row_h + row_h / 2
            parts.append(
                f'<text x="{x0 + 4}" y="{y + 3}" font-size="9" '
                f'fill="#999">q{q}</text>'
            )
        col = 0
        for instr, groups in ops:
            label = _instr_label(instr)
            if not any(groups):
                continue
            x = x0 + 34 + (col % 5) * 30
            col += 1
            for grp in groups:
                if not grp:
                    continue
                ys = [pad + q * row_h + row_h / 2 for q in grp]
                if len(ys) > 1:
                    parts.append(
                        f'<line x1="{x}" y1="{min(ys)}" x2="{x}" '
                        f'y2="{max(ys)}" stroke="#333"/>'
                    )
                for y in ys:
                    parts.append(
                        f'<rect x="{x - 13}" y="{y - 9}" width="26" height="18" '
                        f'fill="#fff" stroke="#333" rx="2"/>'
                        f'<text x="{x}" y="{y + 3}" font-size="8" '
                        f'text-anchor="middle">{html.escape(label[:4])}</text>'
                    )
    parts.append("</svg>")
    return Diagram("".join(parts))


def render_zx_svg(g) -> Diagram:
    """Simple SVG of a ZX graph (Z green, X red, boundary black)."""
    from ..zx.graph import BOUNDARY, HADAMARD, X, Z

    scale = 46
    pad = 30
    verts = list(g.vertices())
    if not verts:
        return Diagram("<svg xmlns='http://www.w3.org/2000/svg'/>")
    min_r = min(g.row(v) for v in verts)
    min_q = min(g.qubit(v) for v in verts)
    max_r = max(g.row(v) for v in verts)
    max_q = max(g.qubit(v) for v in verts)

    def xy(v):
        return (
            pad + (g.row(v) - min_r) * scale,
            pad + (g.qubit(v) - min_q) * scale,
        )

    w = pad * 2 + (max_r - min_r) * scale
    h = pad * 2 + (max_q - min_q) * scale
    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" height="{h}" '
        f'font-family="monospace">'
    ]
    for (u, v) in g.edges():
        x1, y1 = xy(u)
        x2, y2 = xy(v)
        dash = ' stroke-dasharray="4,3" stroke="#36c"' if g.edge_type((u, v)) == HADAMARD else ' stroke="#333"'
        parts.append(f'<line x1="{x1}" y1="{y1}" x2="{x2}" y2="{y2}"{dash}/>')
    for v in verts:
        x, y = xy(v)
        ty = g.type(v)
        fill = {Z: "#9e6", X: "#e66", BOUNDARY: "#333"}.get(ty, "#ccc")
        parts.append(f'<circle cx="{x}" cy="{y}" r="7" fill="{fill}" stroke="#333"/>')
        label = []
        ph = g.phase(v)
        if ph != 0:
            label.append(str(ph))
        ps = g.get_params(v)
        if ps:
            label.append("+".join(sorted(map(str, ps))))
        if label:
            parts.append(
                f'<text x="{x}" y="{y - 10}" font-size="9" text-anchor="middle">'
                f"{html.escape(':'.join(label))}</text>"
            )
    parts.append("</svg>")
    return Diagram("".join(parts))


def render_diagram(circuit, type: str = "timeline-svg", **kwargs):
    """Dispatch for Circuit.diagram (reference ``tsim/circuit.py:647``)."""
    if type == "timeline-svg":
        return render_timeline_svg(
            circuit._stim_circ,
            width=kwargs.get("width"),
            height=kwargs.get("height"),
        )
    if type == "timeslice-svg":
        return render_timeslice_svg(
            circuit._stim_circ,
            width=kwargs.get("width"),
            height=kwargs.get("height"),
        )
    if type == "pyzx":
        return render_zx_svg(circuit.get_graph())
    if type in ("pyzx-dets", "pyzx-meas"):
        from ..core.graph_prep import squash_graph, transform_error_basis
        from ..zx.simplify import full_reduce

        g = circuit.get_sampling_graph(sample_detectors=type == "pyzx-dets")
        full_reduce(g, paramSafe=True)
        g, _ = transform_error_basis(g)
        squash_graph(g)
        return render_zx_svg(g)
    raise ValueError(f"Unknown diagram type: {type}")
