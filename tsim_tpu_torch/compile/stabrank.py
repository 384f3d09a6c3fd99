"""Recursive stabilizer-rank decomposition driver.

Control flow mirrors reference ``tsim/compile/stabrank.py``: reduce, strip
arbitrary-angle (U3) phases, then decompose magic phases, re-reducing and
dropping zero-scalar children at every step.
"""

from __future__ import annotations

from typing import Iterable, Sequence

from ..zx.decompose import (
    DecompositionBudgetExceeded,
    planned_decomposition_step,
    replace_magic_states,
    replace_u3_states,
    tcount,
    u3_count,
)
from ..zx.graph import ZXGraph
from ..zx.simplify import full_reduce


def _graph_state_key(g: ZXGraph):
    """Exact-equality key of a graph's structure plus its symbolic scalar.

    Children of one decomposition share vertex ids, so branches that
    converge to the same intermediate state compare equal as plain dicts —
    no isomorphism needed. Merging them turns the decomposition tree into a
    DAG (constants add), which is exponentially smaller on structured
    circuits (e.g. cultivation checks).
    """
    adj = tuple(
        sorted((v, tuple(sorted(nbrs.items()))) for v, nbrs in g._adj.items())
    )
    verts = tuple(
        sorted(
            (v, g._ty[v], str(g._phase[v]), tuple(sorted(g._params[v])))
            for v in g._ty
        )
    )
    return (verts, adj, _scalar_signature(g))


def _check_budget(n: int, max_terms: int | None) -> None:
    # 4x headroom: intermediate levels shrink through merging/zero pruning.
    if max_terms is not None and n > 4 * max_terms:
        raise DecompositionBudgetExceeded(n)


def _decompose(
    graphs: Sequence[ZXGraph],
    count_fn,
    replace_fn,
    max_terms: int | None = None,
    tight: bool = False,
) -> list[ZXGraph]:
    results: list[ZXGraph] = []
    level: list[ZXGraph] = list(graphs)
    # Cumulative-work budget alongside the set-size budget: zero-branch
    # pruning can hold the working set small while the recursion visits
    # (and fully reduces) exponentially many children — a losing variant
    # then burns minutes under a set-size cap alone. Each visit is charged
    # by the child's residual magic count (1 + count): reducing a child
    # costs time proportional to its size, and its count bounds the
    # subtree still owed, so a hopeless wide recursion (top-level children
    # at count ~55 on the grown-cultivation rungs) exhausts the budget
    # after a few hundred reductions while a genuine winner's tree —
    # visits dominated by near-leaf children at count 0-4 — stays cheap
    # well past its final term count. 32x is permissive for winners;
    # ``tight`` (racing against an already-landed variant) drops to 8x,
    # still generous for a strictly-better challenger.
    visit_factor = 8 if tight else 32
    visits = 0
    while level:
        _check_budget(len(level) + len(results), max_terms)
        nxt: list[ZXGraph] = []
        for graph in level:
            if count_fn(graph) == 0:
                results.append(graph)
                continue
            gsum = replace_fn(graph.copy())
            for g in gsum.graphs:
                visits += 1
                if max_terms is not None and visits > visit_factor * max_terms:
                    raise DecompositionBudgetExceeded(visits)
                full_reduce(g, paramSafe=True)
                if g.scalar.is_zero:
                    continue
                visits += count_fn(g)
                nxt.append(g)
        level = merge_equal_states(nxt) if len(nxt) > 1 else nxt
    return results


def find_stab_magic(
    graphs: Iterable[ZXGraph],
    strategy: str,
    max_terms: int | None = None,
    tight: bool = False,
) -> list[ZXGraph]:
    if strategy == "cat5":
        pending = [(g, 0) for g in graphs]
        # Planned joint pair-projector pass first: gadgetize every magic
        # phase, plan a min-rank perfect matching, and enumerate only the
        # GF(2)-consistent branch assignments (2^rank leaves directly).
        # Heavy plans (rank above the peel threshold) are not enumerated:
        # one probed projector split peels the instance into 2 branches
        # that re-plan far below rank - 1 (the full-plug plateau fix; see
        # zx.decompose._peel_branches). Peel branches keep depth (and the
        # full search budget); enumeration leaves descend a level.
        # Graphs the planner declines fall through to per-pair recursion.
        # Recursion leaves (depth > 0) re-plan with a small search budget:
        # their matchings are small-rank and near-greedy, and a full-budget
        # ILS per leaf would dominate compile time (hundreds of leaves per
        # heavy rung).
        recurse: list[ZXGraph] = []
        results: list[ZXGraph] = []
        while pending:
            _check_budget(len(pending) + len(results), max_terms)
            g, depth = pending.pop()
            if tcount(g) == 0:
                results.append(g)
                continue
            step = planned_decomposition_step(
                g, restarts=512 if depth == 0 else 32, max_terms=max_terms
            )
            if step is None:
                recurse.append(g)
            else:
                kind, children = step
                d = depth if kind == "peel" else depth + 1
                pending.extend((child, d) for child in children)
        results.extend(
            _decompose(
                recurse,
                count_fn=tcount,
                replace_fn=lambda g: replace_magic_states(
                    g, pick_random=False, strategy=strategy
                ),
                max_terms=max_terms,
                tight=tight,
            )
        )
        return merge_equal_states(results) if len(results) > 1 else results
    return _decompose(
        list(graphs),
        count_fn=tcount,
        replace_fn=lambda g: replace_magic_states(g, pick_random=False, strategy=strategy),
        max_terms=max_terms,
        tight=tight,
    )


def find_stab_u3(
    graphs: Iterable[ZXGraph],
    strategy: str,
    max_terms: int | None = None,
    tight: bool = False,
) -> list[ZXGraph]:
    return _decompose(
        list(graphs),
        count_fn=u3_count,
        replace_fn=lambda g: replace_u3_states(g, strategy=strategy),
        max_terms=max_terms,
        tight=tight,
    )


def _scalar_signature(g: ZXGraph):
    """Canonical key of a scalar graph's *symbolic* (param-dependent) part."""
    s = g.scalar
    nodes = tuple(
        sorted(
            (str(p), tuple(sorted(v)))
            for p, v in zip(s.phasenodes, s.phasenodevars)
        )
    )
    halfpi = tuple(
        sorted(
            (j, tuple(sorted(tuple(sorted(vs)) for vs in lst)))
            for j, lst in s.phasevars_halfpi.items()
            if lst
        )
    )
    pipairs = tuple(
        sorted(
            tuple(sorted((tuple(sorted(psi)), tuple(sorted(phi)))))
            for psi, phi in s.phasevars_pi_pair
        )
    )
    pairs = tuple(
        sorted(
            tuple(
                sorted(
                    [
                        (pp.alpha, tuple(sorted(pp.paramsA))),
                        (pp.beta, tuple(sorted(pp.paramsB))),
                    ]
                )
            )
            for pp in s.phasepairs
        )
    )
    return (nodes, halfpi, pipairs, pairs, tuple(sorted(s.phasevars_pi)))


def _merge_constants(members: list[ZXGraph]) -> ZXGraph | None:
    """Sum the constant scalar prefactors of graphs with equal symbolic
    parts into the first member (exactly in Z[w]*sqrt(2)^p when possible).
    Returns None when the sum is exactly/numerically zero."""
    import cmath
    import math

    from ..zx.scalar import ExactDyadic

    base = members[0]
    s0 = base.scalar
    exact = all(
        abs(complex(m.scalar.approximate_floatfactor) - 1.0) < 1e-15
        and m.scalar.phase.denominator in (1, 2, 4)
        for m in members
    )
    if exact:
        p_min = min(m.scalar.power2 for m in members)
        total = ExactDyadic(0, 0, 0, 0)
        for m in members:
            s = m.scalar
            d = s.floatfactor.mul_omega_pow(int(s.phase * 4) % 8)
            dp = s.power2 - p_min
            if dp % 2:
                d = d * ExactDyadic(0, 1, 0, -1)  # sqrt(2)
                dp -= 1
            shift = 1 << (dp // 2)
            d = ExactDyadic(d.a * shift, d.b * shift, d.c * shift, d.d * shift)
            total = ExactDyadic(
                total.a + d.a, total.b + d.b, total.c + d.c, total.d + d.d
            )
        if total.is_zero():
            return None
        s0.power2 = p_min
        s0.phase = type(s0.phase)(0)
        s0.floatfactor = total
        s0.approximate_floatfactor = 1.0
        return base
    scale = max(
        abs(
            2.0 ** (m.scalar.power2 / 2.0)
            * abs(m.scalar.floatfactor.to_complex())
            * abs(complex(m.scalar.approximate_floatfactor))
        )
        for m in members
    )
    total_c = 0j
    for m in members:
        s = m.scalar
        total_c += (
            2.0 ** (s.power2 / 2.0)
            * cmath.exp(1j * math.pi * float(s.phase))
            * s.floatfactor.to_complex()
            * complex(s.approximate_floatfactor)
        )
    if scale > 0 and abs(total_c) / scale < 1e-14:
        return None
    s0.power2 = 0
    s0.phase = type(s0.phase)(0)
    s0.floatfactor = ExactDyadic(1, 0, 0, 0)
    s0.approximate_floatfactor = total_c
    return base


def _merge_by_key(graphs: list[ZXGraph], key_fn) -> list[ZXGraph]:
    groups: dict = {}
    order: list = []
    for g in graphs:
        key = key_fn(g)
        if key not in groups:
            groups[key] = [g]
            order.append(key)
        else:
            groups[key].append(g)
    out: list[ZXGraph] = []
    for key in order:
        members = groups[key]
        if len(members) == 1 or key[0] == "__opaque__":
            out.extend(members)
            continue
        merged = _merge_constants(members)
        if merged is not None:
            out.append(merged)
    return out


def merge_parallel_graphs(graphs: list[ZXGraph]) -> list[ZXGraph]:
    """Merge scalar graphs whose symbolic parts coincide by summing their
    constant prefactors.

    Decomposition branches frequently differ only in pulled constants; a
    merged sum keeps term counts (the kernel's G axis) at the number of
    *distinct* parameter dependencies. Graphs whose merged constant is
    exactly zero are dropped.
    """

    def key_fn(g):
        if g.num_vertices() != 0 or g.scalar.is_zero:
            return ("__opaque__", id(g))
        return ("s", _scalar_signature(g))

    return _merge_by_key(graphs, key_fn)


def _canonical_state_key(g: ZXGraph):
    """Isomorphism-canonical key via color refinement, or None.

    Vertices start colored by (type, phase, params, boundary position) and
    refine on sorted neighbor (color, edge type) multisets. When refinement
    ends with every vertex a unique color, the color order IS a canonical
    labeling and the returned key is exact under relabeling (two graphs get
    equal keys iff they are isomorphic with matching data). Ties -> None
    (caller falls back to the id-based key): correctness never depends on
    refinement succeeding.
    """
    verts = list(g._ty)
    base = {}
    in_pos = {v: i for i, v in enumerate(g._inputs)}
    out_pos = {v: i for i, v in enumerate(g._outputs)}
    for v in verts:
        base[v] = (
            g._ty[v],
            str(g._phase[v]),
            tuple(sorted(g._params[v])),
            in_pos.get(v, -1),
            out_pos.get(v, -1),
        )
    palette = {c: i for i, c in enumerate(sorted(set(base.values())))}
    colors = {v: palette[base[v]] for v in verts}
    n_colors = len(palette)
    for _ in range(len(verts)):
        if n_colors == len(verts):
            break
        sig = {
            v: (colors[v], tuple(sorted((colors[n], t) for n, t in g._adj[v].items())))
            for v in verts
        }
        palette = {c: i for i, c in enumerate(sorted(set(sig.values())))}
        new_colors = {v: palette[sig[v]] for v in verts}
        new_n = len(palette)
        if new_n == n_colors:
            break
        colors, n_colors = new_colors, new_n
    if n_colors != len(verts):
        return None
    rank = {v: colors[v] for v in verts}
    cverts = tuple(
        (rank[v],) + base[v][:3] for v in sorted(verts, key=rank.get)
    )
    cedges = tuple(
        sorted(
            (min(rank[u], rank[v]), max(rank[u], rank[v]), t)
            for u in verts
            for v, t in g._adj[u].items()
            if rank[u] < rank[v]
        )
    )
    return (cverts, cedges, _scalar_signature(g))


def merge_equal_states(graphs: list[ZXGraph]) -> list[ZXGraph]:
    """Merge in-flight decomposition branches with equal graph state.

    Branches are keyed canonically up to vertex relabeling when color
    refinement individualizes every vertex (the common case for these
    sparse, richly-labeled graphs); otherwise by exact vertex ids. Symbolic
    scalars must match exactly in both cases; only constant prefactors sum.
    """

    def key_fn(g):
        if g.scalar.is_zero:
            return ("__opaque__", id(g))
        ck = _canonical_state_key(g)
        if ck is not None:
            return ("c", ck)
        return ("g", _graph_state_key(g))

    return _merge_by_key(graphs, key_fn)


def find_stab(
    graph: ZXGraph,
    strategy: str,
    max_terms: int | None = None,
    tight: bool = False,
) -> list[ZXGraph]:
    """Decompose into a sum of Clifford (stabilizer) scalar graphs.

    ``max_terms``: optional budget; raises DecompositionBudgetExceeded when
    the working set exceeds 4x the budget (variant-selection abort).
    ``tight``: the budget is a landed competitor's term count, not a
    speculative cap — abort losing work earlier (8x vs 32x visit budget).
    """
    full_reduce(graph, paramSafe=True)
    graphs = find_stab_u3([graph], strategy=strategy, max_terms=max_terms, tight=tight)
    return merge_parallel_graphs(
        find_stab_magic(graphs, strategy=strategy, max_terms=max_terms, tight=tight)
    )
