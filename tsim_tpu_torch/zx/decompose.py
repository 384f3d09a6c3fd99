"""Stabilizer-rank decomposition of non-Clifford ZX diagrams.

Splits a diagram with magic (pi/4-multiple) and arbitrary-angle phases into
a sum of Clifford diagrams. Strategies (same names as the reference API,
reference ``tsim/compile/stabrank.py``):

* ``cutting``: single-vertex 2-way cuts (chi = 2^T).
* ``bss``: T-pair decomposition: two magic phases -> 2 terms via an
  equality/anti-equality hub split (chi = 2^(T/2)); derived from
  w^(x1+x2) = [x1=x2] i^(x1) + w [x1 != x2], oracle-verified.
* ``cat5``: pair strategy with gadget-leaf cuts preferred (leaves vanish
  immediately under reduction).

All decompositions are exact: coefficients are dyadic elements of Z[w].
"""

from __future__ import annotations

import cmath
import math
from fractions import Fraction
from typing import Sequence

from .graph import BOUNDARY, HADAMARD, SIMPLE, X, Z, ZXGraph
from .scalar import ExactDyadic, omega_pow_dyadic


class GraphSum:
    def __init__(self, graphs: list[ZXGraph]):
        self.graphs = graphs


class DecompositionBudgetExceeded(Exception):
    """Raised when a decomposition variant exceeds the caller's term budget
    (used by the compile pipeline to abort losing heuristic variants
    early)."""


_DECOMP_DEBUG = __import__("os").environ.get("TSIM_TPU_COMPILE_DEBUG", "") == "1"

# Matching-cost weight of a pair the validity filter will drop (its two
# gadgets fall to per-leaf re-planning/recursion), in units of rank
# doublings; unmatched gadgets are charged half this. Measured on the
# grown-cultivation full-plug rung: dropping 17 pairs multiplied the leaf
# count by ~2^6.3 (~0.37 doublings per dropped pair), so a full doubling
# per drop overweights the filter and pushes the planner to high-rank
# all-kept matchings that enumerate worse than they recurse.
_PLAN_DROP_PENALTY = 1.0


def _ddebug(msg: str) -> None:
    if _DECOMP_DEBUG:
        print(f"[tsim-tpu decompose] {msg}", flush=True)


def _effective_denominator(g: ZXGraph, v: int) -> int:
    return g.phase(v).denominator


def tcount(g: ZXGraph) -> int:
    """Number of vertices whose constant phase is an odd multiple of pi/4."""
    return sum(1 for v in g.vertices() if _effective_denominator(g, v) == 4)


def u3_count(g: ZXGraph) -> int:
    """Number of vertices with non-Clifford+T (arbitrary-angle) phases."""
    return sum(1 for v in g.vertices() if _effective_denominator(g, v) not in (1, 2, 4))


def _t_vertices(g: ZXGraph) -> list[int]:
    return [v for v in g.vertices() if _effective_denominator(g, v) == 4]


def _is_gadget_leaf(g: ZXGraph, v: int) -> bool:
    if g.degree(v) != 1:
        return False
    (h,) = g.neighbors(v)
    return g.type(h) == Z and g.degree(h) >= 2


def cut_vertex(g: ZXGraph, v: int) -> GraphSum:
    """Split on the constant phase of ``v``:

    Z_n(a + pi P) = (1+e^{ia})/2 * Z_n(pi P)  +  (1-e^{ia})/2 * Z_n(pi + pi P)

    Exact for dyadic ``a``; arbitrary angles use the approximate float factor.
    """
    a = g.phase(v)
    g0 = g.copy()
    g1 = g.copy()
    g0.set_phase(v, 0)
    g1.set_phase(v, 1)
    if a.denominator in (1, 2, 4):
        k = int(a * 4) % 8
        wk = omega_pow_dyadic(k)
        # (1 + w^k)/2 and (1 - w^k)/2 with the /2 as power2 -= 2 each.
        g0.scalar.mul_dyadic(ExactDyadic(wk.a + 1, wk.b, wk.c, wk.d))
        g0.scalar.add_power(-2)
        g1.scalar.mul_dyadic(ExactDyadic(1 - wk.a, -wk.b, -wk.c, -wk.d))
        g1.scalar.add_power(-2)
    else:
        z = cmath.exp(1j * math.pi * float(a))
        g0.scalar.mul_float((1 + z) / 2)
        g1.scalar.mul_float((1 - z) / 2)
    return GraphSum([g0, g1])


def split_t_pair(g: ZXGraph, v1: int, v2: int) -> GraphSum:
    """Remove one pi/4 from each of two magic vertices using

        w^{x1+x2} = [x1 = x2] * i^{x1}  +  w * [x1 != x2]

    Term A adds an equality hub Z(pi/2) simple-connected to both vertices;
    term B adds an anti-equality hub (Z(0) hub with an X(pi) NOT spider on
    the second arm) and scalar w. Oracle-verified in tests/unit/zx.
    """
    gA = g.copy()
    gA.add_to_phase(v1, Fraction(-1, 4))
    gA.add_to_phase(v2, Fraction(-1, 4))
    hub = gA.add_vertex(Z, qubit=g.qubit(v1), row=(g.row(v1) + g.row(v2)) / 2,
                        phase=Fraction(1, 2))
    gA.add_edge((hub, v1), SIMPLE)
    gA.add_edge((hub, v2), SIMPLE)

    gB = g.copy()
    gB.add_to_phase(v1, Fraction(-1, 4))
    gB.add_to_phase(v2, Fraction(-1, 4))
    hub = gB.add_vertex(Z, qubit=g.qubit(v1), row=(g.row(v1) + g.row(v2)) / 2)
    notv = gB.add_vertex(X, qubit=g.qubit(v2), row=g.row(v2), phase=Fraction(1))
    gB.add_edge((hub, v1), SIMPLE)
    gB.add_edge((hub, notv), SIMPLE)
    gB.add_edge((notv, v2), SIMPLE)
    gB.scalar.add_phase(Fraction(1, 4))
    return GraphSum([gA, gB])


def _bss_pick(g: ZXGraph, eligible: list[int]) -> list[int]:
    """Choose 6 magic vertices for a BSS split: prefer low degree (leaves
    vanish fastest under reduction) and, among the chosen six, put the
    three with the largest mutual neighbor overlap first (they receive
    the triangle, which then pivots away locally)."""
    chosen = sorted(eligible, key=lambda v: (g.degree(v), v))[:6]
    best = None
    for tri in _triples(chosen):
        rest = [v for v in chosen if v not in tri]
        ov = sum(
            len(set(g.neighbors(a)) & set(g.neighbors(b)))
            for i, a in enumerate(tri)
            for b in tri[i + 1 :]
        )
        if best is None or ov > best[0]:
            best = (ov, list(tri) + rest)
    return best[1]


def _triples(vs):
    import itertools

    return list(itertools.combinations(vs, 3))


def split_bss6(g: ZXGraph, vs: Sequence[int] | None = None) -> GraphSum:
    """Exact 6-magic-phase -> 7-term stabilizer decomposition (real BSS).

    Implements the reference's ``strategy="bss"`` semantics (reference
    ``tsim/compile/stabrank.py:38-52``, pyzx-param BSS): chi = 7^(T/6)
    ~= 2^(0.468 T) instead of the pair split's 2^(T/2).

    Derivation (ours, not a port): with x_v the spider values of six magic
    vertices, each contributes ``w^{x_v}`` (w = e^{i pi/4}) once an odd
    pi/4 is factored out. The identity, oracle-derived and verified in
    dev/derive_bss.py + tests/unit/zx:

      w^{|x|} =   (w/2)   [|x| odd] (-1)^{K3(x1,x2,x3)}
                + (w^7/2) [|x| odd] (-1)^{K3(x1,x2,x3)} i^{|x|}
                + ((1+sqrt2) w^3/4)
                + (-(1+sqrt2) w/4)  i^{|x|}
                + ((sqrt2-1) w^3/4) (-1)^{|x|}
                + (-(sqrt2-1) w/4)  (-i)^{|x|}
                + 2 [x1=...=x6] (-i)^{x1}

    where K3(a,b,c) = ab+ac+bc.  Structurally this is the BSS form: four
    product terms, a GHZ term, and two parity-selected terms with a
    triangle quadratic on one triple whose asymmetric parts cancel.
    Realization: [|x| odd] is a fresh Z(pi) hub H-connected to all six
    (factor (1-(-1)^{|x|})/sqrt2^6), each K3 edge is an H edge
    (factor (-1)^{x_a x_b}/sqrt2), the GHZ is a Z(-pi/2) hub
    simple-connected to all six; power2 compensates every 1/sqrt2.
    """
    ts = list(vs) if vs is not None else _t_vertices(g)
    assert len(ts) >= 6
    ts = ts[:6]
    qrow = sum(g.row(v) for v in ts) / 6.0
    qq = min(g.qubit(v) for v in ts) - 1.0

    def base(extra_phase: Fraction | int) -> ZXGraph:
        gg = g.copy()
        for v in ts:
            gg.add_to_phase(v, Fraction(-1, 4) + Fraction(extra_phase))
        return gg

    from .rules import add_edge_resolve

    # Four product terms: coefficients c = dyadic/4 (power2 -4).
    prod_coeffs = [
        (0, ExactDyadic(-1, 0, 1, 1)),  # 1:      (1+sqrt2) w^3 / 4
        (Fraction(1, 2), ExactDyadic(-1, -1, -1, 0)),  # i^w:  -(1+sqrt2) w / 4
        (1, ExactDyadic(-1, 0, 1, -1)),  # (-1)^w: (sqrt2-1) w^3 / 4
        (Fraction(3, 2), ExactDyadic(-1, 1, -1, 0)),  # (-i)^w: -(sqrt2-1) w / 4
    ]
    out = []
    for extra, dy in prod_coeffs:
        gg = base(extra)
        gg.scalar.mul_dyadic(dy)
        gg.scalar.add_power(-4)
        out.append(gg)

    # GHZ term: Z(-1/2) hub simple-connected to all six; coefficient 2.
    gg = base(0)
    hub = gg.add_vertex(Z, qubit=qq, row=qrow, phase=Fraction(-1, 2))
    for v in ts:
        gg.add_edge((hub, v), SIMPLE)
    gg.scalar.add_power(2)
    out.append(gg)

    # Two parity terms: Z(pi) hub H-connected to all six plus a triangle of
    # H edges on the first triple. The hub contributes 2*[|x| odd]/sqrt2^6
    # (the selector comes with an inherent factor 2), the triangle
    # sqrt2^-3; coefficient w/2 (resp. w^7/2 = -w^3/2 with i^w phases):
    # power2 = -2 + 6 + 3 - 2 = +5.
    for extra, dy, tri in (
        (0, ExactDyadic(0, 1, 0, 0), ts[:3]),
        (Fraction(1, 2), ExactDyadic(0, 0, 0, -1), ts[:3]),
    ):
        gg = base(extra)
        hub = gg.add_vertex(Z, qubit=qq, row=qrow, phase=Fraction(1))
        for v in ts:
            gg.add_edge((hub, v), HADAMARD)
        for a, b in ((tri[0], tri[1]), (tri[0], tri[2]), (tri[1], tri[2])):
            add_edge_resolve(gg, a, b, HADAMARD)
        gg.scalar.mul_dyadic(dy)
        gg.scalar.add_power(5)
        out.append(gg)
    return GraphSum(out)


def _anti_fuse(g: ZXGraph, a: int, b: int) -> None:
    """Enforce ``x_b = NOT x_a`` and merge b into a (all-H spiders).

    Each of b's H neighbors n picks up a pi (the (-1)^{x_n} from y = 1^x)
    and re-attaches to a; b's own phase evaluates at 1 xor x_a: constant
    e^{i pi phase(b)} and sign (-1)^{params(b)} go to the scalar, while the
    x_a-dependence folds into a's phase/params.
    """
    from .rules import add_edge_resolve

    g.scalar.add_phase(g.phase(b))
    pb = g.get_params(b)
    if pb:
        g.scalar.add_pi_var(pb)
    pending = [n for n in g.neighbors(b)]
    phase_b = g.phase(b)
    row_b, qubit_b = g.row(b), g.qubit(b)
    g.remove_vertex(b)
    for n in pending:
        if n == a:
            # (-1)^{x_a (1 xor x_a)} = 1: the edge drops, but its implicit
            # 1/sqrt(2) stays.
            g.scalar.add_power(-1)
            continue
        if g.type(n) == BOUNDARY:
            # Splice the pi onto the wire (cannot phase a boundary).
            w = g.add_vertex(
                Z, qubit=qubit_b, row=(row_b + g.row(n)) / 2, phase=Fraction(1)
            )
            g.add_edge((w, n), SIMPLE)
            add_edge_resolve(g, a, w, HADAMARD)
            continue
        g.add_to_phase(n, 1)
        add_edge_resolve(g, a, n, HADAMARD)
    g.add_to_phase(a, (-phase_b) % 2)
    g.xor_params(a, pb)


def split_conjugate_gadget_pair(
    g: ZXGraph, l1: int, h1: int, l2: int, h2: int, a: int, b: int
) -> GraphSum:
    """3-term split of two conjugate phase gadgets whose targets differ by
    exactly one vertex on each side (T1 = S + {a}, T2 = S + {b}).

    With hub-summed gadget factors G_k = A_k + B_k (-1)^{sigma_k} and
    conjugate leaves (A2 = conj(A1), B2 = conj(B1); equal leaf and hub
    param sets), the [x_a = x_b] branch's cross terms cancel exactly
    (Re(A1 conj(B1)) = 0), leaving:

    * E:  fuse(a, b), scalar 4                         (gadgets vanish)
    * O1: anti-fuse(a, b), scalar 4 cos(pi alpha) (-1)^P
    * O2: anti-fuse(a, b), pi on S and a, scalar -4i sin(pi alpha)
          (-1)^(P xor Q)

    where P is the shared leaf param set and Q the shared hub param set.
    Each branch removes both gadgets entirely (T-count -2) and adds no
    residual structure. Oracle-verified in tests/unit/zx.
    """
    import math

    alpha = g.phase(l1)
    P = g.get_params(l1)
    Q = g.get_params(h1)
    S = (set(g.neighbors(h1)) - {l1, a}) & (set(g.neighbors(h2)) - {l2, b})
    norm_power = -(g.degree(h1) + g.degree(h2)) + 4  # hubs' edges; the 4

    def strip(gg):
        gg.scalar.add_power(norm_power)
        for v in (l1, l2, h1, h2):
            gg.remove_vertex(v)

    from .rules import _fuse_pair

    gE = g.copy()
    strip(gE)
    if not gE.connected(a, b):
        gE.add_edge((a, b), SIMPLE)
        _fuse_pair(gE, a, b)
    else:
        # Existing H edge between a and b: adding the fusing simple edge
        # goes through exact parallel-edge resolution.
        from .rules import add_edge_resolve

        add_edge_resolve(gE, a, b, SIMPLE)

    gO = g.copy()
    strip(gO)
    _anti_fuse(gO, a, b)
    gO1 = gO
    gO2 = gO.copy()
    gO1.scalar.mul_float(math.cos(math.pi * float(alpha)))
    if P:
        gO1.scalar.add_pi_var(P)
    gO2.scalar.mul_float(-math.sin(math.pi * float(alpha)))
    gO2.scalar.add_phase(Fraction(1, 2))  # the factor i
    pq = frozenset(P) ^ frozenset(Q)
    if pq:
        gO2.scalar.add_pi_var(pq)
    for t in S:
        gO2.add_to_phase(t, 1)
    gO2.add_to_phase(a, 1)
    return GraphSum([gE, gO1, gO2])


def apply_pair_projector(
    g: ZXGraph, l1: int, h1: int, l2: int, h2: int, c: int
) -> None:
    """One branch (``c`` = 0 equality / 1 anti-equality) of the gadget-pair
    parity-projector split, mutating ``g`` in place. See
    :func:`split_gadget_pair_projector` for the derivation; both branches
    together sum exactly to the original diagram."""
    a1 = g.phase(l1)
    a2 = g.phase(l2)
    P1 = frozenset(g.get_params(l1))
    Pd = P1 ^ frozenset(g.get_params(l2))
    Qd = frozenset(g.get_params(h1)) ^ frozenset(g.get_params(h2))
    T1 = set(g.neighbors(h1)) - {l1}
    T2 = set(g.neighbors(h2)) - {l2}
    D = T1 ^ T2
    qrow = (g.row(h1) + g.row(h2)) / 2
    qq = g.qubit(h1) - 0.5
    g.remove_vertex(l1)
    g.remove_vertex(h1)
    g.set_phase(l2, ((a1 + a2) if c == 0 else (a2 - a1)) % 2)
    g.set_params(l2, Pd)
    hub = g.add_vertex(Z, qubit=qq, row=qrow, phase=Fraction(c))
    g.set_params(hub, Qd)
    for t in D:
        g.add_edge((hub, t), HADAMARD)
    g.scalar.add_power(len(D) - len(T1) - 1)
    if c:
        g.scalar.add_phase(a1)
        if P1:
            g.scalar.add_pi_var(P1)


def split_gadget_pair_projector(
    g: ZXGraph, l1: int, h1: int, l2: int, h2: int
) -> GraphSum:
    """2-term projector split of ANY pair of phase gadgets.

    A gadget (leaf ``l(a + pi P)`` --H-- hub ``h(0, Q)`` --H-- targets T)
    contributes ``sqrt(2)^(1-|T|) * e^{i a' sigma}`` with
    ``sigma = parity(T values) xor parity(Q)`` and ``a' = a + pi parity(P)``
    (derived by contracting leaf+hub; verified by the tensor oracle).

    Partition the pair's double sum by ``sigma1 xor sigma2``. A *parity
    projector* onto ``parity(D) xor parity(Q1^Q2) = c`` for
    D = T1 symdiff T2 is a bare Z spider (phase c*pi, params Q1^Q2)
    H-connected to D, worth ``sqrt(2)^(2-|D|) [match]``. Both branches
    remove gadget 1 and retarget gadget 2:

    * E (sigma1 = sigma2): joint factor e^{i(a1'+a2') sigma2}: gadget 2's
      leaf becomes ``a1+a2`` with params P1^P2, plus the c=0 projector.
    * O (sigma1 != sigma2): factor e^{i a1'} e^{i(a2'-a1') sigma2}:
      gadget 2's leaf becomes ``a2-a1`` with params P1^P2, plus the c=1
      projector; scalar phase += a1, pi-var P1.

    Both branches: power += |D| - |T1| - 1. The branches are Clifford
    whenever a1+a2 and a1-a2 are multiples of pi/2 — true for ANY two
    odd multiples of pi/4, with no conjugacy or parameter-equality
    requirement. Each branch removes both magic phases (T-count -2) and
    fuses the two supports into one projector spider (which immediately
    pivots/fuses onward), so doubled-diagram mirror gadgets collapse
    instead of accumulating residual hubs: 2^(T/2) worst case with far
    stronger in-flight merging. Oracle-verified in tests/unit/zx.
    """
    gE = g.copy()
    apply_pair_projector(gE, l1, h1, l2, h2, 0)
    gO = g.copy()
    apply_pair_projector(gO, l1, h1, l2, h2, 1)
    return GraphSum([gE, gO])


def _projector_gadgets(g: ZXGraph, ts: list[int]):
    """All magic phase gadgets eligible for projector splitting, as
    ``(leaf, hub, frozenset(targets))`` triples."""
    gadgets = []
    for v in ts:
        if g.degree(v) != 1 or not _all_h(g, v):
            continue
        (h,) = g.neighbors(v)
        if g.type(h) != Z or g.phase(h) != 0 or not _all_h(g, h):
            continue
        if g.is_boundary_registered(h):
            continue
        targets = frozenset(g.neighbors(h)) - {v}
        if any(g.type(t) != Z or g.is_boundary_registered(t) for t in targets):
            continue
        gadgets.append((v, h, targets))
    return gadgets


def _find_projector_gadget_pair(g: ZXGraph, ts: list[int], strict: bool = True):
    """(l1, h1, l2, h2) for a projector-splittable gadget pair.

    ``strict`` restricts to pairs with equal leaf params whose phases sum
    or cancel to a multiple of pi (doubled-diagram ket/bra mirrors) —
    measured to merge best on the cultivation ladder; the loose tier
    accepts any odd-eighth-turn pair and runs only when no strict match
    exists. Prefers conjugate pairs with maximal support overlap (small
    symdiff keeps the projector local).
    """
    gadgets = _projector_gadgets(g, ts)
    best = None
    for i, (l1, h1, t1) in enumerate(gadgets):
        for l2, h2, t2 in gadgets[i + 1 :]:
            if h1 == h2 or h2 in t1 or h1 in t2 or l2 in t1 or l1 in t2:
                continue
            if ((g.phase(l1) + g.phase(l2)) % 2).denominator > 2:
                continue
            if ((g.phase(l1) - g.phase(l2)) % 2).denominator > 2:
                continue
            conj = (g.phase(l1) + g.phase(l2)) % 2 == 0
            same = g.phase(l1) == g.phase(l2)
            eqp = g.get_params(l1) == g.get_params(l2)
            if strict and not (eqp and (conj or same)):
                continue
            score = (
                (2000 if eqp else 0)
                + (1000 if conj else 0)
                + len(t1 & t2) * 10
                - len(t1 ^ t2)
            )
            if best is None or score > best[0]:
                best = (score, l1, h1, l2, h2)
    if best is None:
        return None
    return best[1:]


def _find_conjugate_gadget_pair(g: ZXGraph, ts: list[int]):
    """(l1, h1, l2, h2, a, b) for conjugate gadgets with symdiff {a}, {b}."""
    gadgets = []
    for v in ts:
        if g.degree(v) != 1 or not _all_h(g, v):
            continue
        (h,) = g.neighbors(v)
        if g.type(h) != Z or g.phase(h) != 0 or not _all_h(g, h):
            continue
        gadgets.append((v, h, frozenset(g.neighbors(h)) - {v}))
    for i, (l1, h1, t1) in enumerate(gadgets):
        for l2, h2, t2 in gadgets[i + 1 :]:
            if h1 == h2:
                continue
            if (g.phase(l1) + g.phase(l2)) % 2 != 0:
                continue
            if g.get_params(l1) != g.get_params(l2):
                continue
            if g.get_params(h1) != g.get_params(h2):
                continue
            d1 = t1 - t2
            d2 = t2 - t1
            if len(d1) != 1 or len(d2) != 1:
                continue
            (a,) = d1
            (b,) = d2
            special = {l1, h1, l2, h2}
            if a in special or b in special or (t1 & t2) & special:
                continue
            if not (_all_h(g, a) and _all_h(g, b)):
                continue
            if g.type(a) != Z or g.type(b) != Z:
                continue
            return l1, h1, l2, h2, a, b
    return None


def _best_t_pair(g: ZXGraph, ts: list[int]) -> tuple[int, int]:
    """Pick the magic pair to split: prefer conjugate phases (doubled-diagram
    mirrors, whose equality branch cancels the magic) and shared targets.

    For gadget leaves the relevant neighborhood is the hub's target set."""

    def targets(v):
        if g.degree(v) == 1:
            (h,) = g.neighbors(v)
            return set(g.neighbors(h)) - {v}
        return set(g.neighbors(v))

    best = None
    for i, v1 in enumerate(ts):
        t1 = targets(v1)
        p1 = g.phase(v1)
        for v2 in ts[i + 1 :]:
            conj = 4 if (p1 + g.phase(v2)) % 2 == 0 else 0
            score = conj * 4 + len(t1 & targets(v2))
            if best is None or score > best[0]:
                best = (score, v1, v2)
    assert best is not None
    return best[1], best[2]


import os as _os

_PROJ_ORDER = _os.environ.get("TSIM_TPU_PROJ_SPLIT", "after")


def replace_magic_states(
    g: ZXGraph, pick_random: bool = False, strategy: str = "cat5"
) -> GraphSum:
    """One decomposition step on magic (pi/4) phases; caller recurses."""
    ts = _t_vertices(g)
    if not ts:
        return GraphSum([g])
    if strategy == "cutting":
        return cut_vertex(g, ts[0])
    if strategy == "bss":
        eligible = [
            v for v in ts if g.type(v) == Z and not g.is_boundary_registered(v)
        ]
        if len(eligible) >= 6:
            return split_bss6(g, _bss_pick(g, eligible))
    if strategy == "cat5":
        if _T_FALLBACK == "bss-first":
            eligible = [
                v
                for v in ts
                if g.type(v) == Z and not g.is_boundary_registered(v)
            ]
            if len(eligible) >= 6:
                return split_bss6(g, _bss_pick(g, eligible))
        if _PROJ_ORDER == "before":
            motif = _find_projector_gadget_pair(g, ts)
            if motif is not None:
                return split_gadget_pair_projector(g, *motif)
        motif = _find_conjugate_gadget_pair(g, ts)
        if motif is not None:
            return split_conjugate_gadget_pair(g, *motif)
        if _PROJ_ORDER != "off":
            motif = _find_projector_gadget_pair(g, ts, strict=True)
            if motif is None and _PROJ_ORDER == "loose":
                motif = _find_projector_gadget_pair(g, ts, strict=False)
            if motif is not None:
                return split_gadget_pair_projector(g, *motif)
    if _T_FALLBACK == "bss":
        eligible = [
            v for v in ts if g.type(v) == Z and not g.is_boundary_registered(v)
        ]
        if len(eligible) >= 6:
            return split_bss6(g, _bss_pick(g, eligible))
    if len(ts) >= 2:
        return split_t_pair(g, *_best_t_pair(g, ts))
    return cut_vertex(g, ts[0])


def _pin_vertex(g: ZXGraph, v: int, c: int) -> None:
    """Keep only the ``x_v = c`` branch of all-H-edge Z spider ``v``.

    The spider's tensor sums over its value; selecting the branch ``c = 1``
    multiplies the scalar by ``e^{i·pi·phase(v)}·(-1)^{xor(params(v))}`` and
    pushes a pi phase onto each Hadamard neighbor; ``c = 0`` contributes 1.
    Each removed H edge carried a 1/sqrt(2): power2 -= degree.
    """
    g.scalar.add_power(-g.degree(v))
    if c:
        g.scalar.add_phase(g.phase(v))
        params = g.get_params(v)
        if params:
            g.scalar.add_pi_var(params)
        for n in g.neighbors(v):
            g.add_to_phase(n, 1)
    g.remove_vertex(v)


def split_conjugate_pair(g: ZXGraph, v1: int, v2: int) -> GraphSum:
    """Joint 3-term decomposition of two phases summing to a Clifford angle.

    For spiders with phases ``a + pi·P1`` and ``b + pi·P2`` where ``a + b``
    has denominator in {1, 2, 4}, partition the double sum over their values
    (x, y) into three exact branches:

    * x = y: the spiders fuse; combined phase ``a + b``, params ``P1 ^ P2``.
    * (x, y) = (1, 0): both pinned; scalar ``e^{i·pi·a}·(-1)^{xor(P1)}``.
    * (x, y) = (0, 1): both pinned; scalar ``e^{i·pi·b}·(-1)^{xor(P2)}``.

    Exact (a sum partition, no coefficient fitting); 3 terms for a conjugate
    (+theta, -theta) pair vs 4 from cutting both vertices independently.
    Requires all-H edges on both spiders (graph-like form). An H edge
    *between* them adds ``(-1)^{xy}``: pi on the fused spider, nothing on the
    pinned branches.
    """
    from .rules import _fuse_pair

    adjacent = g.connected(v1, v2)

    gF = g.copy()
    fused_phase = (gF.phase(v1) + gF.phase(v2)) % 2
    if adjacent:
        gF.remove_edge((v1, v2))
        fused_phase = (fused_phase + 1) % 2
        gF.scalar.add_power(-1)  # the removed H edge's 1/sqrt(2)
    gF.set_phase(v1, fused_phase)
    gF.set_phase(v2, 0)
    gF.add_edge((v1, v2), SIMPLE)
    _fuse_pair(gF, v1, v2)

    gP = g.copy()
    _pin_vertex(gP, v1, 1)
    _pin_vertex(gP, v2, 0)

    gQ = g.copy()
    _pin_vertex(gQ, v2, 1)
    _pin_vertex(gQ, v1, 0)

    return GraphSum([gF, gP, gQ])


def _all_h(g: ZXGraph, v: int) -> bool:
    return g.type(v) == Z and all(
        g.edge_type((v, n)) == HADAMARD for n in g.neighbors(v)
    )


def split_doubled_state_pair(
    g: ZXGraph, l1: int, h1: int, l2: int, h2: int
) -> GraphSum:
    """3-term decomposition of a doubled injected state: two conjugate
    arbitrary-angle leaves on conjugate Clifford+T hosts.

    Motif: ``leaf l1 (phase a + pi*P) --H-- host h1 (phase b + pi*Pb)`` and its
    mirror ``l2 (-a + pi*P) --H-- h2 (-b + pi*Pd)`` — exactly the shape a
    non-Clifford state injection takes in a doubled (ket (x) bra) diagram.
    With x, y the host spider values, the motif's joint factor is
    ``F(x,y) = psi(x) * conj(psi)(y)`` with ``psi(x) = (1 + e^{ia'}(-1)^x)
    e^{ib'x} / sqrt(2)``. Partition into three exact Clifford branches:

    * D1 (diagonal, even): hosts fused, leaves gone; scalar 2/2 = 1.
    * D2 (diagonal, odd):  hosts fused plus a pi phase; scalar
      ``cos(pi a) * (-1)^P``.
    * O (off-diagonal): hosts linked by a NOT (X(pi), simple edges), h1 gains
      pi; scalar ``i * sin(pi a) * (-1)^P``.

    Each branch eliminates both arbitrary-angle leaves AND both host T
    phases (D branches cancel b against -b; O keeps hosts' b in-graph where
    the pair remains a conjugate T pair) — the key to reference-level term
    counts on the distillation workloads (reference d3: 148 terms).
    Oracle-verified in tests/unit/zx.
    """
    import math

    a = g.phase(l1)
    P = g.get_params(l1)

    gD1 = g.copy()
    gD1.scalar.add_power(-2)  # two removed leaf H-edges
    gD1.remove_vertex(l1)
    gD1.remove_vertex(l2)
    gD1.set_phase(h1, 0)
    gD1.set_phase(h2, 0)
    gD1.scalar.add_power(2)  # constant diagonal coefficient 2
    gD2 = gD1.copy()
    from .rules import _fuse_pair

    for gd in (gD1, gD2):
        gd.add_edge((h1, h2), SIMPLE)
        _fuse_pair(gd, h1, h2)
    gD2.add_to_phase(h1, 1)
    gD2.scalar.add_power(-2)  # cos factor replaces the constant 2
    gD2.scalar.mul_float(2.0 * math.cos(math.pi * float(a)))
    if P:
        gD2.scalar.add_pi_var(P)

    # Off-diagonal branch: anti-fuse h2 into h1 directly (y = NOT x): push a
    # pi onto each of h2's H-neighbors, move h2's phase/params onto h1, and
    # pull the constant pieces into the scalar. Doing the anti-fusion here
    # (rather than leaving an X(pi) NOT spider) immediately combines the two
    # conjugate host phases into the single Clifford angle 2b + pi.
    from .rules import add_edge_resolve

    gO = g.copy()
    # The two leaf-edge 1/sqrt(2) factors are already inside the pulled
    # coefficient i*sin(pi a) (each psi carries one), so no power change.
    gO.remove_vertex(l1)
    gO.remove_vertex(l2)
    b = g.phase(h1)
    Pd = g.get_params(h2)
    gO.scalar.add_phase(Fraction(1, 2))  # the factor i
    gO.scalar.mul_float(math.sin(math.pi * float(a)))
    if P:
        gO.scalar.add_pi_var(P)
    gO.scalar.add_phase((-b) % 2)  # e^{-i pi b} from h2 evaluated at y = 1
    if Pd:
        gO.scalar.add_pi_var(Pd)
    pending = [n for n in gO.neighbors(h2)]
    gO.remove_vertex(h2)
    for n in pending:
        if gO.type(n) == BOUNDARY:
            # Cannot push a pi onto a boundary: splice a pi spider onto the
            # wire (h1 --H-- w(pi) --S-- boundary keeps the edge's tensor).
            w = gO.add_vertex(
                Z, qubit=gO.qubit(n), row=(g.row(h2) + gO.row(n)) / 2,
                phase=Fraction(1),
            )
            gO.add_edge((w, n), SIMPLE)
            add_edge_resolve(gO, h1, w, HADAMARD)
            continue
        gO.add_to_phase(n, 1)
        add_edge_resolve(gO, h1, n, HADAMARD)
    gO.add_to_phase(h1, b)  # h2's x-dependence folds in: total 2b + pi
    gO.xor_params(h1, Pd)
    gO.add_to_phase(h1, 1)  # pi from the off-diagonal leaf factor

    return GraphSum([gD1, gD2, gO])


def _find_doubled_state_pair(g: ZXGraph, u3s: list[int]):
    """Find (l1, h1, l2, h2): conjugate u3 leaves on conjugate Clifford hosts."""
    leaves = []
    for v in u3s:
        if g.degree(v) != 1 or not _all_h(g, v):
            continue
        (h,) = g.neighbors(v)
        if g.type(h) != Z or not _all_h(g, h) or g.degree(h) < 2:
            continue
        if g.phase(h).denominator not in (1, 2, 4):
            continue
        leaves.append((v, h))
    for i, (l1, h1) in enumerate(leaves):
        for l2, h2 in leaves[i + 1 :]:
            if h1 == h2 or g.connected(h1, h2):
                continue
            if ((g.phase(l1) + g.phase(l2)) % 2) != 0:
                continue
            if g.get_params(l1) != g.get_params(l2):
                continue
            if ((g.phase(h1) + g.phase(h2)) % 2) != 0:
                continue
            return l1, h1, l2, h2
    return None


def replace_u3_states(g: ZXGraph, strategy: str = "cat5") -> GraphSum:
    """One decomposition step on arbitrary-angle phase vertices.

    Prefers joint pair elimination: two arbitrary-angle spiders whose phases
    sum to a Clifford (denominator <= 4) angle decompose into 3 terms instead
    of the 4 produced by cutting each separately. Doubled diagrams pair every
    ket-side rotation ``+theta`` with its bra-side mirror ``-theta``, so this
    is the common case (reference workloads: the distillation injection
    rotations, reference ``docs/demos/magic_state_distillation.ipynb``).
    """
    u3s = [
        v
        for v in g.vertices()
        if _effective_denominator(g, v) not in (1, 2, 4)
        and not g.is_boundary_registered(v)
    ]
    if not u3s:
        return GraphSum([g])
    motif = _find_doubled_state_pair(g, u3s)
    if motif is not None:
        return split_doubled_state_pair(g, *motif)
    # Among all Clifford-sum pairs prefer the one sharing the most neighbors:
    # in doubled diagrams the ket rotation's mirror (bra) partner overlaps
    # through the joined measurement vertices, and fusing mirror partners
    # keeps the branch local (fusing across unrelated blocks couples them and
    # blocks downstream reduction).
    best = None
    for i, v1 in enumerate(u3s):
        if not _all_h(g, v1):
            continue
        n1 = set(g.neighbors(v1))
        for v2 in u3s[i + 1 :]:
            if not _all_h(g, v2):
                continue
            if ((g.phase(v1) + g.phase(v2)) % 2).denominator not in (1, 2, 4):
                continue
            overlap = len(n1 & set(g.neighbors(v2)))
            if best is None or overlap > best[0]:
                best = (overlap, v1, v2)
    if best is not None:
        return split_conjugate_pair(g, best[1], best[2])
    return cut_vertex(g, u3s[0])


# ---------------------------------------------------------------------------
# Planned joint pair-projector decomposition
#
# Instead of splitting one gadget pair per recursion level (2^pairs branches
# pruned only by zero-scalar detection), plan a perfect matching of ALL magic
# gadgets up front and enumerate only the branch assignments consistent with
# the GF(2) structure of the pairs' parity constraints.
#
# Each pair split introduces the constraint ``parity(D_p) = c_p xor
# parity(Qd_p)`` (D_p = target symdiff, Qd_p = hub-param symdiff). Over all
# assignments of values to the underlying vertices, the reachable c-vectors
# form an affine subspace of dimension rank{(D_p | Qd_p)} over GF(2): for
# every dependency ``xor_S (D_p | Qd_p) = 0`` only ``xor_S c_p = 0``
# branches are nonzero. Enumerating exactly that subspace yields 2^rank
# leaves directly — no decomposition tree, no zero-branch waste. On the d=3
# cultivation benchmark this gives 128 terms where per-pair recursion gave
# 4051 and the reference's published workload has 1024 (reference
# ``docs/benchmarks.svg`` panel 3).
# ---------------------------------------------------------------------------


_T_FALLBACK = "pair"


_T_FALLBACK_KINDS = ("pair", "bss", "bss-first")


def set_t_fallback(kind: str) -> str:
    """Select the last-resort magic-phase split when no planner motif fits.

    ``"pair"`` (default) splits the best T pair (chi = 2^(T/2)); ``"bss"``
    applies the exact 6->7 BSS identity when >= 6 eligible magic spiders
    remain (chi = 7^(T/6) ~= 2^(0.468 T)); ``"bss-first"`` tries the BSS
    identity before consulting the planner motifs at all (used in the
    docs/benchmarks.md knob sweep). BSS wins asymptotically but its
    children merge/prune differently, so the compile pipeline races both on
    components where the planner declined and keeps the smaller
    decomposition. Returns the previous value.
    """
    if kind not in _T_FALLBACK_KINDS:
        raise ValueError(
            f"Unknown t-fallback kind {kind!r}; expected one of {_T_FALLBACK_KINDS}"
        )
    global _T_FALLBACK
    prev = _T_FALLBACK
    _T_FALLBACK = kind
    return prev


_PI_HUB_NORMALIZE = True


def set_pi_hub_normalize(on: bool) -> bool:
    """Toggle pi-phase-hub gadget normalization inside gadgetize_magic.

    Normalizing exposes more gadgets to the pair planner (essential on the
    2-check cultivation ladder: largest plug 30052 -> 2048 terms) but
    perturbs the greedy matching trajectory, which occasionally loses to
    the unnormalized plan on small workloads — the compile pipeline tries
    both and keeps the smaller decomposition (like the shake toggle).
    Returns the previous value.
    """
    global _PI_HUB_NORMALIZE
    prev = _PI_HUB_NORMALIZE
    _PI_HUB_NORMALIZE = on
    return prev


def set_plan_drop_penalty(w: float) -> float:
    """Set the planner's matching cost for filter-dropped pairs (see
    ``_PLAN_DROP_PENALTY``). The compile pipeline races 1.0 against 0.375
    on heavy rungs: which side of the trade-off wins is structure-
    dependent. Returns the previous value."""
    global _PLAN_DROP_PENALTY
    prev = _PLAN_DROP_PENALTY
    _PLAN_DROP_PENALTY = w
    return prev


def gadgetize_magic(g: ZXGraph) -> bool:
    """Unfuse every non-gadget magic (odd pi/4) phase into a phase gadget.

    ``Z_E(a + pi P)  =  Z_E(0) --H-- Z(0) --H-- Z_1(a + pi P)`` exactly (no
    scalar: the hub's two Hadamards contract to a delta). Oracle-verified in
    tests/unit/zx. Returns True if anything changed.
    """
    changed = False
    for v in list(g.vertices()):
        if _effective_denominator(g, v) != 4:
            continue
        if g.type(v) != Z or g.is_boundary_registered(v) or not _all_h(g, v):
            continue
        if g.degree(v) == 1:
            (h,) = g.neighbors(v)
            if g.type(h) == Z and g.degree(h) >= 2:
                if (
                    _PI_HUB_NORMALIZE
                    and g.phase(h) == 1
                    and not g.is_boundary_registered(h)
                ):
                    # pi-phase hub: the pi flips the gadget parity, so
                    # gadget(a, hub pi) = e^{i pi a} (-1)^P gadget(-a, hub 0)
                    # (oracle-verified). Normalizing makes the gadget
                    # visible to the pair planner.
                    a = g.phase(v)
                    P = g.get_params(v)
                    g.set_phase(h, 0)
                    g.scalar.add_phase(a)
                    if P:
                        g.scalar.add_pi_var(P)
                    g.set_phase(v, (-a) % 2)
                    changed = True
                continue  # already a gadget leaf
        a = g.phase(v)
        P = g.get_params(v)
        g.set_phase(v, 0)
        g.set_params(v, ())
        hub = g.add_vertex(Z, qubit=g.qubit(v) - 0.5, row=g.row(v))
        leaf = g.add_vertex(Z, qubit=g.qubit(v) - 1.0, row=g.row(v), phase=a)
        g.set_params(leaf, P)
        g.add_edge((v, hub), HADAMARD)
        g.add_edge((hub, leaf), HADAMARD)
        changed = True
    return changed


def plan_projector_cover(g: ZXGraph, gadgets, restarts: int = 512) -> list[tuple]:
    """Min-rank perfect matching over projector-splittable gadget pairs.

    Returns a list of ``(i, j, vec)`` gadget-index pairs with their
    constraint vectors (vertex ids plus ("param", name) coordinates),
    minimizing the GF(2) rank of the chosen vectors (the planned leaf
    count is 2^rank). Pairs whose symdiff D contains another chosen pair's
    leaf or hub are dropped (their constraint coordinates would be removed
    by the other split).

    The pair vectors factor through per-gadget vectors — ``vec(i, j) =
    u_i XOR u_j`` with ``u_i = targets(i) | params(hub_i)`` — so this is a
    min-rank matching problem on the ``u_i``. A dependent-first greedy
    builds the initial matching; a seeded 2-swap iterated local search
    (re-pairing two matched pairs, accepting cost-non-increasing moves so
    plateaus can be walked, kicking from the best on stalls) then drives
    the cost far below the greedy plateau: on the grown-cultivation heavy
    rungs the greedy-with-restarts planner this replaces plateaued at
    rank 16 (65,536 leaves) where the search finds rank <=9 (<=512
    leaves) in ~30k moves. The cost charges ``2*(rank + dropped) +
    unmatched``: a pair the validity filter will drop leaves its two
    gadgets to per-pair recursion, one extra 2-way split (+1 doubling)
    per pair, same as two unmatched gadgets. ``restarts`` scales the move
    budget (kept for API compatibility). Deterministic: fixed RNG seed,
    move-count budget.
    """
    import random

    n = len(gadgets)
    allowed_set = set()
    orig_vec = {}
    for i in range(n):
        l1, h1, t1 = gadgets[i]
        for j in range(i + 1, n):
            l2, h2, t2 = gadgets[j]
            if h2 in t1 or h1 in t2 or l2 in t1 or l1 in t2:
                continue
            if ((g.phase(l1) + g.phase(l2)) % 2).denominator > 2:
                continue
            if ((g.phase(l1) - g.phase(l2)) % 2).denominator > 2:
                continue
            D = t1 ^ t2
            Qd = frozenset(g.get_params(h1)) ^ frozenset(g.get_params(h2))
            orig_vec[(i, j)] = frozenset(D) | {("param", p) for p in Qd}
            allowed_set.add((i, j))
    if not allowed_set:
        return []

    # Bitmask encoding: coordinates are every D/param coordinate plus
    # every gadget leaf/hub id (so the validity-filter test is a mask op).
    # XOR/elimination are single machine-word ops per 64 coordinates.
    # Coordinate ids are assigned in str-sorted order so the planner (and
    # hence term counts) is stable across representations.
    all_coords = set()
    for (l, h, t) in gadgets:
        all_coords |= set(t)
        all_coords |= {("param", p) for p in g.get_params(h)}
        all_coords |= {l, h}
    coord_id = {c: k for k, c in enumerate(sorted(all_coords, key=str))}
    umask = []
    lhmask = []
    for (l, h, t) in gadgets:
        m = 0
        for c in t:
            m |= 1 << coord_id[c]
        for p in g.get_params(h):
            m |= 1 << coord_id[("param", p)]
        umask.append(m)
        lhmask.append((1 << coord_id[l]) | (1 << coord_id[h]))
    dmask = {}
    for (i, j), vec in orig_vec.items():
        m = 0
        for c in vec:
            if not isinstance(c, tuple):
                m |= 1 << coord_id[c]
        dmask[(i, j)] = m

    drop_w = _PLAN_DROP_PENALTY
    # 8n^2 scaling keeps recursion-leaf replans (n ~ 8-34, called per
    # planned leaf) at milliseconds while the big top-level rungs (n >= 58)
    # get the full restarts*n moves the heavy plateaus need.
    budget = min(restarts * n, 8 * n * n)

    # Native search: the greedy + iterated local search below, ported into
    # the C++ engine (zx_plan_cover) over fixed-width bitsets — plan calls
    # drop from seconds to milliseconds on the heavy 58-gadget rungs,
    # which dominate compile time once enumeration is native too. Its
    # deterministic RNG differs from the Python fallback's, so plans (and
    # term counts) are pinned against the native path.
    from .native_simplify import native_plan_cover

    native_pairs = native_plan_cover(
        umask, lhmask, dmask, allowed_set, drop_w, budget
    )
    if native_pairs is not None:
        return _finish_plan_cover(native_pairs, gadgets, orig_vec, coord_id)

    def _reduce(v: int, basis: list) -> int:
        # basis kept in descending order with distinct msbs (echelon), so
        # one pass fully reduces.
        for b in basis:
            w = v ^ b
            if w < v:
                v = w
        return v

    def _cost(pair_list) -> float:
        # rank of filter-surviving pairs, plus penalties for pairs the
        # validity filter will drop and for unmatched gadgets (both fall
        # to later recursion; see _PLAN_DROP_PENALTY).
        lh = 0
        for (i, j) in pair_list:
            lh |= lhmask[i] | lhmask[j]
        basis: list = []
        r = 0
        dropped = 0
        for (i, j) in pair_list:
            own = lhmask[i] | lhmask[j]
            if dmask[(i, j)] & lh & ~own:
                dropped += 1
                continue
            v = _reduce(umask[i] ^ umask[j], basis)
            if v:
                basis.append(v)
                basis.sort(reverse=True)
                r += 1
        return r + drop_w * dropped + 0.5 * drop_w * (n - 2 * len(pair_list))

    # Dependent-first greedy start (pairs whose vector is already in the
    # span are rank-free; otherwise prefer small residuals; pairs that
    # would be dropped against the all-gadgets leaf/hub set come last).
    lh_all = 0
    for m_ in lhmask:
        lh_all |= m_
    cand = sorted(allowed_set)
    unmatched = set(range(n))
    basis: list = []
    cur: list = []
    while len(unmatched) > 1:
        pick = None
        for (i, j) in cand:
            if i not in unmatched or j not in unmatched:
                continue
            own = lhmask[i] | lhmask[j]
            dirty = 1 if dmask[(i, j)] & lh_all & ~own else 0
            v = _reduce(umask[i] ^ umask[j], basis)
            key = (dirty, 1 if v else 0, v.bit_count())
            if pick is None or key < pick[0]:
                pick = (key, i, j, v)
                if key == (0, 0, 0):
                    break
        if pick is None:
            break
        _, i, j, v = pick
        if v:
            basis.append(v)
            basis.sort(reverse=True)
        cur.append((i, j))
        unmatched -= {i, j}

    # Iterated local search: seeded 2-swap descent accepting cost-non-
    # increasing moves (plateau walking), with a random multi-swap kick
    # from the best matching whenever progress stalls. Move budget scales
    # with problem size; cost evaluation is a full (cheap) re-elimination
    # of ~n/2 int vectors.
    def _swap_opts(pa, pb):
        (i, j), (k, l) = pa, pb
        opts = []
        p = (min(i, k), max(i, k))
        q = (min(j, l), max(j, l))
        if p in allowed_set and q in allowed_set:
            opts.append((p, q))
        p = (min(i, l), max(i, l))
        q = (min(j, k), max(j, k))
        if p in allowed_set and q in allowed_set:
            opts.append((p, q))
        return opts

    rnd = random.Random(0x51AB)
    m = len(cur)
    cur_cost = _cost(cur)
    best_pairs, best_cost = list(cur), cur_cost
    since = 0
    stall = max(1024, budget // 8)
    while budget > 0 and m >= 2:
        budget -= 1
        since += 1
        if since > stall:
            # Kick: restart from the best matching perturbed by a few
            # unconditional random swaps, then descend again.
            cur = list(best_pairs)
            for _ in range(3):
                a = rnd.randrange(m)
                b = rnd.randrange(m - 1)
                if b >= a:
                    b += 1
                opts = _swap_opts(cur[a], cur[b])
                if opts:
                    cur[a], cur[b] = opts[rnd.randrange(len(opts))]
            cur_cost = _cost(cur)
            since = 0
            continue
        a = rnd.randrange(m)
        b = rnd.randrange(m - 1)
        if b >= a:
            b += 1
        opts = _swap_opts(cur[a], cur[b])
        if not opts:
            continue
        p1, p2 = opts[rnd.randrange(len(opts))]
        old_a, old_b = cur[a], cur[b]
        cur[a], cur[b] = p1, p2
        c = _cost(cur)
        if c <= cur_cost:
            cur_cost = c
            if c < best_cost:
                best_pairs, best_cost = list(cur), c
                since = 0
        else:
            cur[a], cur[b] = old_a, old_b
    return _finish_plan_cover(best_pairs, gadgets, orig_vec, coord_id)


def _finish_plan_cover(best_pairs, gadgets, orig_vec, coord_id):
    """Shared tail of plan_projector_cover: integer-coordinate constraint
    vectors (the consistency eliminator needs orderable coordinates) plus
    the validity filter — drop pairs whose D references another chosen
    pair's removed vertices (orig_vec distinguishes vertex ids from
    ("param", name) tuples)."""
    chosen = [
        (i, j, frozenset(coord_id[c] for c in orig_vec[(i, j)]))
        for (i, j) in best_pairs
    ]
    lh = set()
    for (i, j, _) in chosen:
        lh |= {gadgets[i][0], gadgets[i][1], gadgets[j][0], gadgets[j][1]}
    valid = []
    for (i, j, vec) in chosen:
        own = {gadgets[i][0], gadgets[i][1], gadgets[j][0], gadgets[j][1]}
        D = {x for x in orig_vec[(i, j)] if not isinstance(x, tuple)}
        if D & (lh - own):
            continue
        valid.append((i, j, vec))
    return valid


def _consistency_exprs(vectors: list[frozenset]):
    """GF(2)-reduce the pair constraint vectors.

    Returns ``(free_count, exprs)``: the affine subspace of consistent
    branch choices has 2^free_count points, and each pair's bit is the XOR
    of the free bits in its expression."""
    basis: dict = {}
    free_count = 0
    exprs = []  # per pair: frozenset of free indices whose XOR gives c_p
    for vec in vectors:
        v = set(vec)
        expr: set = set()
        while v:
            piv = max(v)
            b = basis.get(piv)
            if b is None:
                # v_p is independent: give it free bit K; the residual v
                # equals u_K xor the reduction expression.
                basis[piv] = (frozenset(v), frozenset(expr) ^ {free_count})
                exprs.append(frozenset({free_count}))
                free_count += 1
                break
            bv, be = b
            v ^= bv
            expr ^= be
        else:
            exprs.append(frozenset(expr))
    return free_count, exprs


def _consistent_assignments(vectors: list[frozenset], max_rank: int):
    """Enumerate the affine subspace of consistent branch choices.

    Returns a list of c-tuples (one bit per pair), or None when the rank
    exceeds ``max_rank``."""
    import itertools

    free_count, exprs = _consistency_exprs(vectors)
    if free_count > max_rank:
        return None
    out = []
    for bits in itertools.product((0, 1), repeat=free_count):
        out.append(tuple(sum(bits[k] for k in e) & 1 for e in exprs))
    return out


def _build_plan(g: ZXGraph, restarts: int):
    """Gadgetize a copy of ``g`` and plan its pair-projector cover.

    Returns ``(work, gadgets, pairs, rank)`` or None when planning is not
    applicable (too few gadgets or pairs)."""
    work = g.copy()
    gadgetize_magic(work)
    ts = _t_vertices(work)
    gadgets = _projector_gadgets(work, ts)
    if len(gadgets) < 4:
        return None
    pairs = plan_projector_cover(work, gadgets, restarts)
    if len(pairs) < 2:
        _ddebug(f"plan declined: {len(gadgets)} gadgets, {len(pairs)} pairs")
        return None
    rank, exprs = _consistency_exprs([vec for (_, _, vec) in pairs])
    return work, gadgets, pairs, rank, exprs


def _independent_plan_pairs(pairs):
    """Indices of plan pairs whose constraint vector is GF(2)-independent
    of the preceding ones (one per enumeration dimension), in plan order."""
    basis: dict = {}
    indep = []
    for idx, (_, _, vec) in enumerate(pairs):
        v = set(vec)
        while v:
            piv = max(v)
            b = basis.get(piv)
            if b is None:
                basis[piv] = frozenset(v)
                indep.append(idx)
                break
            v ^= b
    return indep


# Peel while the planned enumeration rank exceeds this: one projector split
# costs x2 branches but the re-reduced branches re-plan far below
# rank - 1 on the heavy full-plug rungs (measured on cultivation_d3_grown
# checks=2: root rank 14 -> children rank 9/9 after the best single peel),
# so each peel is a net term-count win while ranks stay above the bar.
_PEEL_RANK_THRESHOLD = 10
# Probe the smallest-constraint-vector candidates and keep the best pair
# (small |vec| correlates with large rank reduction, but imperfectly).
_PEEL_PROBE_CANDIDATES = 4
_PEEL_PROBE_RESTARTS = 128


def _peel_branches(work: ZXGraph, gadgets, pairs) -> list[ZXGraph] | None:
    """Rank-peeling step: split ONE planned pair as a plain 2-branch
    projector recursion instead of enumerating the whole plan.

    Probes the few independent pairs with the smallest constraint vectors:
    for each, applies both projector branches, reduces them, and re-plans;
    keeps the candidate whose worst branch re-plans at the lowest rank.
    Returns the reduced nonzero branches of the winner (the caller re-plans
    them at full strength), or None when there is nothing to peel.
    """
    from .simplify import full_reduce

    indep = _independent_plan_pairs(pairs)
    if not indep:
        return None
    cand = sorted(indep, key=lambda idx: len(pairs[idx][2]))
    cand = cand[:_PEEL_PROBE_CANDIDATES]
    best = None
    for idx in cand:
        i, j, _vec = pairs[idx]
        l1, h1, _t1 = gadgets[i]
        l2, h2, _t2 = gadgets[j]
        branches = []
        ranks = []
        for c in (0, 1):
            gg = work.copy()
            apply_pair_projector(gg, l1, h1, l2, h2, c)
            full_reduce(gg, paramSafe=True)
            if gg.scalar.is_zero:
                continue
            branches.append(gg)
            child = _build_plan(gg, _PEEL_PROBE_RESTARTS)
            # A declined child plan means per-pair recursion over its whole
            # magic count: score it by that worst case.
            ranks.append(child[3] if child is not None else tcount(gg))
        if not branches:
            # Both projector branches reduced to exact zero, so the whole
            # graph's amplitude is zero: an empty peel is the best possible
            # answer (the caller drops the graph entirely).
            return []
        score = (max(ranks), sum(ranks))
        if best is None or score < best[0]:
            best = (score, branches)
    if best is None:
        return None
    _ddebug(f"peel: chose split with child ranks score {best[0]}")
    return best[1]


def planned_decomposition_step(
    g: ZXGraph,
    restarts: int = 512,
    max_terms: int | None = None,
    max_rank: int = 14,
    peel_threshold: int | None = _PEEL_RANK_THRESHOLD,
) -> tuple[str, list[ZXGraph]] | None:
    """One step of the planned decomposition: enumerate or peel.

    Returns ``("enumerate", leaves)`` (the full consistent-branch
    enumeration of the plan), ``("peel", branches)`` (one 2-branch
    projector split chosen to lower the branch plan ranks; branches still
    carry magic and should be re-planned at full search strength), or
    None when planning is not applicable (too few gadgets/pairs, or an
    unpeelable plan over ``max_rank`` with no term budget to arbitrate).
    """
    plan = _build_plan(g, restarts)
    if plan is None:
        return None
    work, gadgets, pairs, rank, exprs = plan
    if peel_threshold is not None and rank > peel_threshold:
        branches = _peel_branches(work, gadgets, pairs)
        if branches is not None:
            return ("peel", branches)
    if max_terms is None and rank > max_rank:
        _ddebug(f"plan declined: rank {rank} > max_rank {max_rank}")
        return None
    leaves = _enumerate_plan(work, gadgets, pairs, rank, exprs, max_terms)
    if leaves is None:
        return None
    return ("enumerate", leaves)


def planned_magic_decomposition(
    g: ZXGraph,
    max_rank: int = 14,
    restarts: int = 512,
    max_terms: int | None = None,
) -> list[ZXGraph] | None:
    """One planned joint-split pass; returns reduced nonzero leaves or None.

    None means planning is not applicable (too few gadget pairs or rank too
    large) and the caller should fall back to per-pair recursion. With
    ``max_terms`` set, a plan whose 2^rank leaf count already exceeds the
    budget raises BEFORE enumerating (each leaf costs a full reduction, so
    a doomed variant would otherwise burn the whole enumeration first).
    """
    plan = _build_plan(g, restarts)
    if plan is None:
        return None
    work, gadgets, pairs, rank, exprs = plan
    if max_terms is None and rank > max_rank:
        _ddebug(f"plan declined: rank {rank} > max_rank {max_rank}")
        return None
    return _enumerate_plan(work, gadgets, pairs, rank, exprs, max_terms)


def _enumerate_plan(
    work: ZXGraph, gadgets, pairs, rank: int, exprs, max_terms: int | None
) -> list[ZXGraph] | None:
    """Enumerate the consistent branch assignments of a planned cover."""
    from .simplify import full_reduce

    import itertools
    if max_terms is not None:
        # Budgeted mode: the 2^rank leaf count is this pass's floor, so a
        # plan already over budget aborts the variant BEFORE enumerating
        # (each leaf costs a full reduction) — and before the catastrophic
        # alternative, falling into 2^(T/2) per-pair recursion.
        if rank >= 62 or (1 << rank) > 4 * max_terms:
            _ddebug(
                f"plan rank {rank} over budget {max_terms}: abort variant"
            )
            raise DecompositionBudgetExceeded(1 << min(rank, 62))
    assigns = [
        tuple(sum(bits[k] for k in e) & 1 for e in exprs)
        for bits in itertools.product((0, 1), repeat=rank)
    ]
    pair_vertex_ids = [
        (gadgets[i][0], gadgets[i][1], gadgets[j][0], gadgets[j][1])
        for (i, j, _) in pairs
    ]
    # Native leaf enumeration: decode the work graph once, apply every
    # branch's projectors + full_reduce in C++, ship back only the nonzero
    # survivors (the Python per-leaf loop costs ~13 ms/leaf in graph
    # copies and Python<->native round-trips — ~200 s on the grown
    # cultivation full plug's 16k leaves).
    from .simplify import _SHAKE_ENABLED
    from .native_simplify import native_planned_enumerate

    leaves = native_planned_enumerate(
        work, pair_vertex_ids, assigns, _SHAKE_ENABLED
    )
    if leaves is not None:
        return leaves
    leaves = []
    for cs in assigns:
        gg = work.copy()
        for (l1, h1, l2, h2), c in zip(pair_vertex_ids, cs):
            apply_pair_projector(gg, l1, h1, l2, h2, c)
        full_reduce(gg, paramSafe=True)
        if gg.scalar.is_zero:
            continue
        leaves.append(gg)
    return leaves
