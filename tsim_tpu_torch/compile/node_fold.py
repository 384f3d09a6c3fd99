"""The node-phase fold of the wide exact kernel (``exact_wide``, K5): its
host tables and its plain reader.

A live node-phase term multiplies a graph's product by ``1 + w^k``, ``k =
phase + 4 parity mod 8``, and the kernel follows it with a reduce step.
Where the phase is 0 or 4, ``k`` is 0 or 4 and the factor exactly 2 or 0:

* ``k = 0``: ``acc + acc`` is even in all four coefficients, so the reduce
  step halves it once: the coefficients come back unchanged and the power
  rises by 1;
* ``k = 4``: ``acc + w^4 acc = 0``, and every later step (rotations, the
  sign, the phase pairs, the prefactor's product, reduce steps) is linear in
  the coefficients, so the product stays exactly 0; an exact sum skips an
  exact zero, and a zero sum is written with power 0, so its power is never
  read.

Every later step's coefficients depend on coefficients alone, and the power
only adds up, so such a slot can leave the per-shot loop: its +1 goes into
the graph's static power, and its parity into one *vanish* bit a shot and
graph, set where some such term has phase 0 and parity 1 or phase 4 and
parity 0. A product that does not vanish keeps the int32 coefficients and
power of the loop over every slot, bit for bit. The graph's dead slots
(past its count, where the loop did a reduce step alone) come after its
live ones in either loop, and keep their reduce steps.

The segments, appended to the exact tables of a rung without approximate
floatfactors (``exact_tables.exact_table_layout``), with K the most kept
terms and F the most folded terms a graph has:

* ``nf_phases`` (K, G): each graph's other live node-phase terms' phases, in
  table order, 0 past their number;
* ``nf_counts`` (G,): their number;
* ``nf_dead`` (G,): the graph's dead node-phase slots, T1 less its count;
* ``nf_power2`` (G,): ``pf_pow`` plus the graph's folded terms;
* ``nf_base``, ``nf_meta``, ``nf_words``: a stream of bit lists
  (``bit_lists``) whose node rows are the K kept terms' masks, in the order
  of ``nf_phases``, then the half-pi, pi-product and phase-pair rows of
  ``bs_*``;
* ``nv_base``, ``nv_meta``, ``nv_words``: a stream of F node rows alone, the
  folded terms' masks, each graph's by falling weight and dead ones last (an
  OR is free of order), ``aux`` 1 for phase 4.

:func:`graph_products` and :func:`kernel_partials` are the plain reader:
K5's arithmetic step for step on the parities of the plain front end
(``bit_lists.sliced_front_end``), with or without the fold, down to the
exact sums in the kernel's order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.gf2 import matmul_gf2
from .bit_lists import _sorted_rows, bit_list_layout, pack_lists, sliced_front_end
from .sample_tables import unpack_words

SHOTS_PER_WARP = 32


def node_fold_layout(k: int, f: int, t2: int, t3: int, t4: int, g: int, kept_words: int,
                     folded_words: int) -> list:
    """The fold's segments, ``(name, shape, kind)`` in storage order; the
    two streams are ``kept_words`` and ``folded_words`` words a graph long."""
    def lists(prefix, *dims):
        return [(name.replace("bs_", prefix, 1), shape, kind) for name, shape, kind in bit_list_layout(*dims)]

    return [
        ("nf_phases", (k, g), "i32"),
        ("nf_counts", (g,), "i32"),
        ("nf_dead", (g,), "i32"),
        ("nf_power2", (g,), "i32"),
        *lists("nf_", k, t2, t3, t4, g, kept_words),
        *lists("nv_", f, 0, 0, 0, g, folded_words),
    ]


def build_node_fold(circuit, masks: np.ndarray, aux: np.ndarray, lengths: np.ndarray) -> dict:
    """Named numpy segments of the fold of one exact rung (see
    :func:`node_fold_layout`), from the rung's rows in list order
    (``bit_lists.ordered_rows``)."""
    np_f = circuit.node_phases
    G = int(circuit.num_graphs)
    t1 = np.shape(np_f.phases)[0]
    phases = (np.asarray(np_f.phases, np.int64) & 7).reshape(t1, G)
    counts = np.asarray(np_f.counts, np.int64).reshape(G)
    live = np.arange(t1)[:, None] < counts[None, :]
    folded = live & (phases & 3 == 0)
    kept = live & ~folded
    n_kept, n_folded = kept.sum(axis=0), folded.sum(axis=0)
    k, f = int(n_kept.max(initial=0)), int(n_folded.max(initial=0))
    node = masks[:t1]  # zero past each graph's count

    along = np.take_along_axis
    order = np.argsort(~kept, axis=0, kind="stable")[:k]  # the kept terms first, in table order
    first = np.arange(k)[:, None] < n_kept[None, :]
    kept_phases = along(phases, order, 0) * first
    kept_masks = along(node, order[..., None], 0) * first[..., None]
    order = _sorted_rows(node.sum(axis=2), folded)[:f]
    live_f = along(folded, order, 0)
    fold_masks = along(node, order[..., None], 0) * live_f[..., None]
    fold_aux = (along(phases, order, 0) == 4) & live_f

    kept_lists = pack_lists(
        np.concatenate([kept_masks, masks[t1:]]).astype(np.uint8),
        np.concatenate([np.zeros((k, G), np.int32), aux[t1:]]),
        lengths,
    )
    folded_lists = pack_lists(fold_masks.astype(np.uint8), fold_aux.astype(np.int32), np.zeros_like(lengths))
    power2 = np.asarray(circuit.prefactor.power2, np.int64).reshape(G)
    return dict(
        nf_phases=kept_phases.astype(np.int32),
        nf_counts=n_kept.astype(np.int32),
        nf_dead=(t1 - counts).astype(np.int32),
        nf_power2=(power2 + n_folded).astype(np.int32),
        **{name.replace("bs_", "nf_", 1): a for name, a in kept_lists.items()},
        **{name.replace("bs_", "nv_", 1): a for name, a in folded_lists.items()},
    )


# ------------------------------------------------------------ the plain reader

def _rot(c: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """w^k c for (4, ...) int32 coefficients and k in [0, 8), staged on the
    bits of k as the kernel's ``rot``."""
    a0, a1, a2, a3 = c
    b = (k & 1) != 0
    a0, a1, a2, a3 = torch.where(b, -a3, a0), torch.where(b, a0, a1), torch.where(b, a1, a2), torch.where(b, a2, a3)
    b = (k & 2) != 0
    a0, a1, a2, a3 = torch.where(b, -a2, a0), torch.where(b, -a3, a1), torch.where(b, a0, a2), torch.where(b, a1, a3)
    b = (k & 4) != 0
    return torch.stack([torch.where(b, -a, a) for a in (a0, a1, a2, a3)])


def _reduce_step(c: torch.Tensor, p: torch.Tensor, where=True):
    """The kernel's reduce step (no all-zero guard), where ``where`` holds."""
    even = (((c[0] | c[1] | c[2] | c[3]) & 1) == 0) & where
    return torch.where(even, c >> 1, c), p + even.to(p.dtype)


def _is_zero(c: torch.Tensor) -> torch.Tensor:
    return (c[0] | c[1] | c[2] | c[3]) == 0


def _add_exact(a, b):
    """The kernel's aligned exact add of b into a: exact zeros skipped, the
    shift clipped at 30, a reduce step."""
    (ca, pa), (cb, pb) = a, b
    s1 = torch.bitwise_left_shift(torch.ones_like(pa), torch.clamp(pa - pb, 0, 30))
    s2 = torch.bitwise_left_shift(torch.ones_like(pb), torch.clamp(pb - pa, 0, 30))
    c, p = _reduce_step(ca * s1 + cb * s2, torch.minimum(pa, pb))
    a_zero, b_zero = _is_zero(ca), _is_zero(cb)
    c = torch.where(b_zero, ca, torch.where(a_zero, cb, c))
    p = torch.where(b_zero, pa, torch.where(a_zero, pb, p))
    return c, p


def _products(v: dict, dims: tuple, front: dict, vanish: torch.Tensor, node_rung: tuple):
    """Each graph's exact product for every row: (4, B, G) coefficients and
    (B, G) power, as the kernel's per-shot stage forms them from the front
    end's parities (``front["node"]`` those of the loop's terms) and the
    vanish bits. ``node_rung`` is (phases (K, G), counts, dead, power2) of
    the node-phase loop."""
    _, t2, t3, t4 = dims
    phases, counts, dead, power2 = node_rung
    B, G = vanish.shape
    c = torch.zeros((4, B, G), dtype=torch.int32)
    c[0] = 1 - vanish.to(torch.int32)
    p = torch.zeros((B, G), dtype=torch.int32)
    for t in range(phases.shape[0]):
        add = c + _rot(c, (phases[t] + 4 * front["node"][:, t]) & 7)
        live = t < counts
        c, p = _reduce_step(torch.where(live, add, c), p, live)
    for i in range(int(dead.max()) if dead.numel() else 0):
        c, p = _reduce_step(c, p, i < dead)
    if t2:
        c = _rot(c, front["tot"] & 7)
    if t3:
        c = c * (1 - 2 * front["sign"])
    qa, qb, qc = (torch.as_tensor(v[n]) for n in ("qp_alpha", "qp_beta", "qp_counts"))
    for t in range(t4):
        a = (qa[t] + 4 * front["alpha"][:, t]) & 7
        b = (qb[t] + 4 * front["beta"][:, t]) & 7
        add = c + _rot(c, a) + _rot(c, b) - _rot(c, (a + b) & 7)
        c = torch.where(t < qc, add, c)
        c, p = _reduce_step(c, p)
    r = _rot(c, torch.as_tensor(v["pf_phase"]) & 7)
    f0, f1, f2, f3 = torch.as_tensor(v["pf_ff"])
    c = torch.stack([
        r[0] * f0 - r[1] * f3 - r[2] * f2 - r[3] * f1,
        r[0] * f1 + r[1] * f0 - r[2] * f3 - r[3] * f2,
        r[0] * f2 + r[1] * f1 + r[2] * f0 - r[3] * f3,
        r[0] * f3 + r[1] * f2 + r[2] * f1 + r[3] * f0,
    ])
    c, p = _reduce_step(c, p)
    return c, p + power2


def _tile_sums(c: torch.Tensor, p: torch.Tensor, tile: int):
    """Per-tile exact sums in the kernel's order: warp w of a tile's block
    adds the tile's graphs w, w + warps, ... one after the other, then the
    warps' sums are added in order; a zero sum is written with power 0."""
    B, G = p.shape
    warps = tile // SHOTS_PER_WARP
    out_c, out_p = [], []
    for g0 in range(0, G, tile):
        n = min(tile, G - g0)
        total = None
        for w in range(warps):
            acc = (torch.zeros((4, B), dtype=torch.int32), torch.zeros(B, dtype=torch.int32))
            for j in range(w, n, warps):
                acc = _add_exact(acc, (c[:, :, g0 + j], p[:, g0 + j]))
            total = acc if total is None else _add_exact(total, acc)
        out_c.append(total[0].T)
        out_p.append(torch.where(_is_zero(total[0]), 0, total[1]))
    return torch.stack(out_c), torch.stack(out_p)


def graph_products(tables, x, fold: bool = True):
    """Each graph's exact product on the (B, P) 0/1 rows ``x`` of the exact
    rung ``tables``, formed on the CPU as K5's per-shot stage forms it: (4,
    B, G) coefficients and (B, G) powers, int32. With ``fold`` it reads the
    fold's segments (the loop over the kept terms, the vanish bit, the dead
    slots' reduce steps, ``nf_power2``); without, the rung's own (the loop
    over every node-phase slot, as K5 did before the fold)."""
    v = {name: a.cpu().numpy() for name, a in tables.views().items()}
    x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x, np.uint8)
    t1, t2, t3, t4 = tables.dims

    def stream(prefix):  # one list stream, under the names sliced_front_end reads
        return {name: v[prefix + name[3:]] for name in ("bs_base", "bs_meta", "bs_words")}

    if fold:
        k, f = tables.fold[:2]
        front = sliced_front_end(stream("nf_"), (k, t2, t3, t4), x)
        folded = stream("nv_")
        constant = (folded["bs_meta"] >> 16) & 1  # (F, G): 1 for phase 4
        vanish = (sliced_front_end(folded, (f, 0, 0, 0), x)["node"] ^ constant[None]).any(axis=1)
        node_rung = (v["nf_phases"], v["nf_counts"], v["nf_dead"], v["nf_power2"])
    else:
        front = sliced_front_end(stream("bs_"), tables.dims, x)
        vanish = np.zeros((x.shape[0], tables.num_graphs), bool)
        node_rung = (v["np_phases"], v["np_counts"], t1 - v["np_counts"], v["pf_pow"])
    front = {name: torch.as_tensor(a.astype(np.int32)) for name, a in front.items()}
    return _products(v, tables.dims, front, torch.as_tensor(vanish), tuple(torch.as_tensor(a) for a in node_rung))


def kernel_partials(tables, x, tile: int, fold: bool = True):
    """K5's per-tile partials of :func:`graph_products` for ``tile`` graphs a
    block: (n_tiles, B, 4) coefficients and (n_tiles, B) powers, int32, the
    exact sums taken in the kernel's order."""
    return _tile_sums(*graph_products(tables, x, fold), tile)


def standing_rows(tables, count: int, seed: int) -> torch.Tensor:
    """(count, P) uint8 rows on which the fold lets products stand: row i
    solves, over GF(2), the folded terms of graph i mod G of the exact rung
    ``tables`` (parity 0 for phase 0, 1 for phase 4), its free parameters
    drawn from ``seed``; a seeded row where no row solves them (the graph
    vanishes on every row). Seeded rows alone leave few such products."""
    v = {name: a.cpu() for name, a in tables.views().items()}
    P, G = tables.n_params, tables.num_graphs
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 2, size=(count, P)).astype(np.uint8)
    phases = v["np_phases"].numpy() & 7
    params = unpack_words(v["np_words"], P).numpy().astype(np.uint8)  # (T1, G, P)
    live = np.arange(phases.shape[0])[:, None] < v["np_counts"].numpy()[None, :]
    for i in range(count):
        g = i % G
        terms = np.flatnonzero(live[:, g] & (phases[:, g] & 3 == 0))
        a = np.concatenate([params[terms, g], (phases[terms, g] == 4)[:, None]], axis=1).astype(np.uint8)
        pivots = []
        for col in range(P):  # reduced row echelon form over GF(2)
            r = len(pivots)
            hit = np.flatnonzero(a[r:, col]) + r
            if not len(hit):
                continue
            a[[r, hit[0]]] = a[[hit[0], r]]
            a[(a[:, col] == 1) & (np.arange(len(a)) != r)] ^= a[r]
            pivots.append(col)
        if a[len(pivots):, -1].any():
            continue
        x = rows[i]
        for j, col in enumerate(pivots):
            x[col] = 0
            x[col] = (a[j, -1] + a[j, :-1].astype(np.int64) @ x) & 1
    return torch.from_numpy(rows)


def vanishing(tables, x: torch.Tensor) -> torch.Tensor:
    """(B, G) bool on ``x``'s device: the products that the fold finds to be
    0, read from the rung's own node-phase tables (each live term of phase 0
    with parity 1 or of phase 4 with parity 0), not from the fold's."""
    v = tables.views()
    phases, counts = v["np_phases"] & 7, v["np_counts"]
    params = unpack_words(v["np_words"], tables.n_params).to(torch.uint8).to(x.device)
    parity = matmul_gf2(params, x).to(torch.int32)  # (B, T1, G)
    live = torch.arange(phases.shape[0], device=phases.device)[:, None] < counts[None, :]
    zero = (live & (phases & 3 == 0)).to(x.device)
    return (zero[None] & (parity != (phases == 4).to(x.device).int()[None])).any(dim=1)
