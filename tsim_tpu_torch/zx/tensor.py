"""Tensor-contraction oracle for ZX graphs.

Contracts a (small) ZX diagram to a dense numpy tensor. This is the ground
truth used to validate every rewrite rule and decomposition in this package
(the reference relies on pyzx-param's ``to_tensor`` the same way, see
reference ``tsim/core/graph.py:447-459``).

Conventions (standard ZX semantics):
 - Z spider, degree n, phase a: entries 1 at index 0..0 and e^{i pi a} at 1..1.
 - X spider: Z spider conjugated by normalized Hadamards on every leg.
 - Hadamard edge: H = [[1, 1], [1, -1]] / sqrt(2).
 - Tensor legs ordered outputs-then-inputs.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np

from .graph import BOUNDARY, HADAMARD, X, ZXGraph

_H = np.array([[1, 1], [1, -1]], dtype=np.complex128) / math.sqrt(2)


def _spider_tensor(ty: int, degree: int, phase: Fraction) -> np.ndarray:
    amp = np.exp(1j * math.pi * float(phase))
    if degree == 0:
        return np.asarray(1 + amp, dtype=np.complex128)
    t = np.zeros((2,) * degree, dtype=np.complex128)
    t[(0,) * degree] = 1
    t[(1,) * degree] = amp
    if ty == X:
        for axis in range(degree):
            t = np.tensordot(t, _H, axes=([axis], [0]))
            t = np.moveaxis(t, -1, axis)
    return t


def graph_to_tensor(
    g: ZXGraph,
    vals: dict | None = None,
    preserve_scalar: bool = True,
) -> np.ndarray:
    """Contract ``g`` to a tensor, substituting parameter values ``vals``.

    Boundary legs are ordered outputs-then-inputs. Parameters default to 0.
    """
    vals = vals or {}
    boundary_order = list(g.outputs()) + list(g.inputs())
    bset = set(boundary_order)
    for v in g.vertices():
        if g.type(v) == BOUNDARY and v not in bset:
            raise ValueError(f"dangling boundary vertex {v} not in inputs/outputs")

    # Wire ids per directed endpoint. Hadamard edges insert an H tensor with
    # two fresh wires; simple edges share one wire.
    wire_of: dict[tuple[int, int], int] = {}
    extra: list[tuple[np.ndarray, list[int]]] = []
    wc = 0
    for (u, v) in g.edges():
        if g.edge_type((u, v)) == HADAMARD:
            w1, w2 = wc, wc + 1
            wc += 2
            wire_of[(u, v)] = w1
            wire_of[(v, u)] = w2
            extra.append((_H.copy(), [w1, w2]))
        elif g.type(u) == BOUNDARY and g.type(v) == BOUNDARY:
            # Bare wire between two boundaries: insert an identity tensor so
            # both open legs are carried by some tensor.
            w1, w2 = wc, wc + 1
            wc += 2
            wire_of[(u, v)] = w1
            wire_of[(v, u)] = w2
            extra.append((np.eye(2, dtype=np.complex128), [w1, w2]))
        else:
            wire_of[(u, v)] = wire_of[(v, u)] = wc
            wc += 1

    pool: list[tuple[np.ndarray, list[int]]] = list(extra)
    for v in g.vertices():
        if g.type(v) == BOUNDARY:
            continue
        nbrs = g.neighbors(v)
        ph = g.phase(v)
        x = 0
        for var in g.get_params(v):
            x ^= int(vals.get(var, 0)) & 1
        t = _spider_tensor(g.type(v), len(nbrs), (ph + x) % 2)
        pool.append((t, [wire_of[(v, n)] for n in nbrs]))

    open_wires = [wire_of[(b, g.neighbors(b)[0])] for b in boundary_order]
    open_set = {}
    for w in open_wires:
        open_set[w] = open_set.get(w, 0) + 1

    result = _contract(pool, open_set)
    tensor, idxs = result

    # Reorder axes to boundary order (wires may repeat if two boundaries share
    # a wire through a bare edge -- not supported here, guarded above by the
    # single-neighbor boundary convention: each boundary has its own wire).
    perm = [idxs.index(w) for w in open_wires]
    tensor = np.transpose(tensor, perm) if tensor.ndim else tensor
    if preserve_scalar:
        tensor = tensor * g.scalar.evaluate(vals)
    return tensor


def _contract(pool, open_set):
    """Sequentially contract tensors sharing wires; returns (tensor, wires)."""
    pool = [(t, list(ix)) for t, ix in pool]
    # Trace internal duplicate wires within a single tensor.
    def trace_dups(t, ix):
        changed = True
        while changed:
            changed = False
            seen = {}
            for pos, w in enumerate(ix):
                if w in seen and w not in open_set:
                    p0 = seen[w]
                    t = np.trace(t, axis1=p0, axis2=pos)
                    ix = [x for i, x in enumerate(ix) if i not in (p0, pos)]
                    changed = True
                    break
                seen[w] = pos
        return t, ix

    pool = [trace_dups(t, ix) for t, ix in pool]

    while True:
        # Find two tensors sharing a non-open wire.
        owner: dict[int, int] = {}
        pair = None
        for i, (_, ix) in enumerate(pool):
            for w in ix:
                if w in open_set:
                    continue
                if w in owner and owner[w] != i:
                    pair = (owner[w], i)
                    break
                owner[w] = i
            if pair:
                break
        if pair is None:
            break
        i, j = pair
        ti, ixi = pool[i]
        tj, ixj = pool[j]
        shared = [w for w in ixi if w in ixj and w not in open_set]
        shared = list(dict.fromkeys(shared))
        ax_i = [ixi.index(w) for w in shared]
        ax_j = [ixj.index(w) for w in shared]
        t = np.tensordot(ti, tj, axes=(ax_i, ax_j))
        ix = [w for k, w in enumerate(ixi) if k not in set(ax_i)] + [
            w for k, w in enumerate(ixj) if k not in set(ax_j)
        ]
        t, ix = trace_dups(t, ix)
        new_pool = [p for k, p in enumerate(pool) if k not in (i, j)]
        new_pool.append((t, ix))
        pool = new_pool

    # Outer product of the remainder.
    if not pool:
        return np.asarray(1.0 + 0j), []
    t, ix = pool[0]
    for t2, ix2 in pool[1:]:
        t = np.multiply.outer(t, t2)
        ix = ix + ix2
    return np.asarray(t), ix


def graphs_sum_to_tensor(graphs, vals: dict | None = None) -> np.ndarray:
    """Sum of tensors of a list of graphs (for decomposition validation)."""
    out = None
    for g in graphs:
        t = graph_to_tensor(g, vals=vals)
        out = t if out is None else out + t
    return out
