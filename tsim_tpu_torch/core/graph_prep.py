"""Sampling-graph preparation: doubling, reduction, error-basis transform.

Pipeline (same stages as reference ``tsim/core/graph.py``):
 1. parse circuit -> ZX diagram with rec/m/det/obs phase variables
 2. double the diagram (compose with adjoint), join rec/m vertex pairs
 3. add boundary outputs for measurements or detectors/observables
 4. full_reduce (parameter-safe)
 5. Gaussian-eliminate error variables: e-basis -> reduced f-basis
"""

from __future__ import annotations

from collections import defaultdict, deque
from dataclasses import dataclass
from fractions import Fraction
from typing import TYPE_CHECKING, Any, Sequence

import numpy as np

from ..ops.gf2 import find_basis
from ..zx.graph import BOUNDARY, HADAMARD, X, Z, ZXGraph
from ..zx.scalar import Scalar
from ..zx.simplify import full_reduce
from .instructions import GraphRepresentation
from .parse import parse_stim_circuit
from .types import SamplingGraph

if TYPE_CHECKING:
    from ..circuit import Circuit


@dataclass
class ConnectedComponent:
    graph: ZXGraph
    output_indices: list[int]


def connected_components(g: ZXGraph) -> list[ConnectedComponent]:
    """Split ``g`` into connected subgraphs with their output indices."""
    components: list[ConnectedComponent] = []
    visited: set[Any] = set()
    outputs = tuple(g.outputs())
    out_index = {v: i for i, v in enumerate(outputs)}

    for v0 in g.vertices():
        if v0 in visited:
            continue
        verts = _collect(g, v0, visited)
        sub = _induced_subgraph(g, verts)
        idxs = sorted(out_index[v] for v in verts if v in out_index)
        components.append(ConnectedComponent(graph=sub, output_indices=idxs))
    return components


def _collect(g: ZXGraph, start, visited) -> list:
    queue = deque([start])
    comp = []
    while queue:
        v = queue.pop()
        if v in visited:
            continue
        visited.add(v)
        comp.append(v)
        for n in g.neighbors(v):
            if n not in visited:
                queue.appendleft(n)
    return comp


def _induced_subgraph(g: ZXGraph, verts: Sequence) -> ZXGraph:
    sub = ZXGraph()
    vmap = {}
    for v in verts:
        nv = sub.add_vertex(
            g.type(v), qubit=g.qubit(v), row=g.row(v), phase=g.phase(v)
        )
        sub.set_params(nv, g.get_params(v))
        vmap[v] = nv
    for v in verts:
        for n in g.neighbors(v):
            if n in vmap and v < n:
                sub.add_edge((vmap[v], vmap[n]), g.edge_type((v, n)))
    sub.set_inputs(tuple(vmap[v] for v in g.inputs() if v in vmap))
    sub.set_outputs(tuple(vmap[v] for v in g.outputs() if v in vmap))
    # The global scalar stays with the full graph; components carry none.
    return sub


def classify_direct(component: ConnectedComponent) -> tuple[int, bool] | None:
    """Output directly equal to one f-variable (optionally flipped)?

    Matches a 2-vertex component: boundary output H-connected to a Z spider
    carrying exactly one ``f`` parameter and constant phase 0 or pi.
    Parameter-free components (deterministic detectors: noise never reaches
    them) classify as constants, returned as ``(-1, value)``.
    """
    g = component.graph
    outs = list(g.outputs())
    if len(outs) != 1 or g.num_vertices() != 2:
        return None
    (v_out,) = outs
    nbrs = g.neighbors(v_out)
    if len(nbrs) != 1:
        return None
    v = nbrs[0]
    if g.type(v) != Z or g.edge_type((v_out, v)) != HADAMARD:
        return None
    params = g.get_params(v)
    ph = g.phase(v)
    if ph not in (0, 1):
        return None
    if len(params) == 0 and not get_params(g):
        return -1, ph == 1
    if len(params) != 1:
        return None
    (p,) = params
    if not (isinstance(p, str) and p.startswith("f")):
        return None
    if get_params(g) != {p}:
        return None
    return int(p[1:]), ph == 1


def build_sampling_graph(
    built: GraphRepresentation, sample_detectors: bool = False
) -> ZXGraph:
    """Double the diagram and wire up outputs for sampling."""
    g = built.graph.copy()

    # Un-initialized first vertices start in |0>.
    for v in built.first_vertex.values():
        if g.type(v) == BOUNDARY:
            g.set_type(v, X)

    if built.last_vertex:
        max_row = max(g.row(v) for v in built.last_vertex.values())
        for q in built.last_vertex:
            g.set_row(built.last_vertex[q], max_row)

    num_measurements = len(built.rec)
    outputs = [v for v in g.vertices() if g.type(v) == BOUNDARY]
    g.set_outputs(tuple(outputs))
    g.set_inputs(())

    g_adj = g.adjoint()
    g.compose(g_adj)

    label_to_vertex: dict[str, list[int]] = defaultdict(list)
    annotation_to_vertex: dict[str, list[int]] = defaultdict(list)
    for v in g.vertices():
        pv = g.get_params(v)
        if len(pv) != 1:
            continue
        (label,) = pv
        if not isinstance(label, str):
            continue
        if "det" in label or "obs" in label or "rec" in label or "m" in label:
            label_to_vertex[label].append(v)
        if "det" in label or "obs" in label:
            annotation_to_vertex[label].append(v)

    new_outputs: list[int] = [0] * num_measurements if not sample_detectors else []

    for k in range(num_measurements):
        label = f"rec[{k}]"
        vs = label_to_vertex[label]
        assert len(vs) == 2, f"{label}: {vs}"
        v0, v1 = vs
        if not g.connected(v0, v1):
            g.add_edge((v0, v1))
        g.set_phase(v0, 0, clearParams=True)
        g.set_phase(v1, 0, clearParams=True)
        if not sample_detectors:
            v3 = g.add_vertex(BOUNDARY, qubit=-1, row=k + 1)
            new_outputs[k] = v3
            g.add_edge((v0, v3))

    for k in range(len(built.silent_rec)):
        label = f"m[{k}]"
        vs = label_to_vertex[label]
        assert len(vs) == 2
        v0, v1 = vs
        if not g.connected(v0, v1):
            g.add_edge((v0, v1))
        g.set_phase(v0, 0, clearParams=True)
        g.set_phase(v1, 0, clearParams=True)

    if not sample_detectors:
        for vs in annotation_to_vertex.values():
            assert len(vs) == 2
            for v in vs:
                g.remove_vertex(v)
    else:
        for vs in annotation_to_vertex.values():
            assert len(vs) == 2
            g.remove_vertex(vs.pop())
        labels = [f"det[{k}]" for k in range(len(built.detectors))] + [
            f"obs[{k}]" for k in sorted(built.observables_dict)
        ]
        for label in labels:
            vs = annotation_to_vertex[label]
            assert len(vs) == 1
            v = vs[0]
            row = g.row(v)
            vb = g.add_vertex(
                BOUNDARY, qubit=-2 if "det" in label else -2.5, row=row
            )
            g.add_edge((v, vb))
            g.set_phase(v, 0, clearParams=True)
            new_outputs.append(vb)

    g.set_outputs(tuple(new_outputs))
    return g


def transform_error_basis(
    g: ZXGraph, num_e: int | None = None
) -> tuple[ZXGraph, np.ndarray]:
    """Rewrite e-variables to a reduced f-basis: returns (g, T) with
    ``f = T @ e (mod 2)`` row-wise (T shape (num_f, num_e)).

    Output-adjacent parametrized vertices are prioritized so f-numbering
    matches output order (maximizing the direct-path identity layout).
    """
    output_detectors = []
    for v_out in g.outputs():
        nbrs = g.neighbors(v_out)
        if len(nbrs) == 1 and g.get_params(nbrs[0]):
            output_detectors.append(nbrs[0])
    out_set = set(output_detectors)
    others = [v for v in g.vertices() if v not in out_set and g.get_params(v)]
    pverts = output_detectors + others

    if not pverts:
        g.scalar = Scalar()
        return g, np.zeros((0, num_e if num_e is not None else 0), dtype=np.uint8)

    for v in pverts:
        for var in g.get_params(v):
            assert isinstance(var, str) and var.startswith("e") and var[1:].isdigit(), (
                f"unexpected phase var {var!r}"
            )
    index_sets = [[int(var[1:]) for var in g.get_params(v)] for v in pverts]
    num_errors = max(max(s) for s in index_sets) + 1
    if num_e is not None:
        num_errors = max(num_errors, num_e)

    error_matrix = np.zeros((len(index_sets), num_errors), dtype=np.uint8)
    for row, idxs in enumerate(index_sets):
        error_matrix[row, idxs] = 1

    basis, transform = find_basis(error_matrix)
    for v, trow in zip(pverts, transform):
        g.set_params(v, {f"f{j}" for j in np.flatnonzero(trow)})
    return g, basis


def get_params(g: ZXGraph) -> set[str]:
    """All parameter variables in the graph and its scalar term families."""
    return g.all_params()


def evaluate_graph(g: ZXGraph, vals: dict | None = None) -> np.ndarray:
    """Oracle: substitute parameter values and contract to a tensor."""
    from ..zx.tensor import graph_to_tensor

    vals = dict(vals or {})
    return np.asarray(graph_to_tensor(g, vals=vals))


def squash_graph(g: ZXGraph) -> None:
    """Compact layout for rendering: BFS placement from outputs."""
    outputs = list(g.outputs())
    if not outputs:
        return
    num_outputs = len(outputs)
    for row, v in enumerate(outputs):
        g.set_row(v, row)
        g.set_qubit(v, num_outputs)
    occupied = {(num_outputs, row) for row in range(num_outputs)}
    placed = set(outputs)
    queue = deque(outputs)
    while queue:
        cur = queue.popleft()
        cq, cr = int(g.qubit(cur)), int(g.row(cur))
        for n in g.neighbors(cur):
            if n in placed:
                continue
            tq, tr = cq - 1, cr
            if (tq, tr) in occupied:
                for off in range(1, 10000):
                    if (tq, tr + off) not in occupied:
                        tr = tr + off
                        break
                    if (tq, tr - off) not in occupied and tr - off >= 0:
                        tr = tr - off
                        break
            g.set_qubit(n, tq)
            g.set_row(n, tr)
            occupied.add((tq, tr))
            placed.add(n)
            queue.append(n)


def prepare_graph(circuit: "Circuit", *, sample_detectors: bool) -> SamplingGraph:
    """Parse, double, reduce and error-transform a circuit for sampling."""
    built = parse_stim_circuit(circuit._stim_circ)
    graph = build_sampling_graph(built, sample_detectors=sample_detectors)
    num_outputs = len(graph.outputs())
    full_reduce(graph, paramSafe=True)
    graph, error_transform = transform_error_basis(graph, num_e=built.num_error_bits)
    # Normalization is computed separately at sampling time; the global
    # scalar of the prepared graph cancels and is dropped.
    graph.scalar = Scalar()
    return SamplingGraph(
        graph=graph,
        error_transform=error_transform,
        channel_probs=built.channel_probs,
        num_outputs=num_outputs,
        num_detectors=len(built.detectors),
    )
