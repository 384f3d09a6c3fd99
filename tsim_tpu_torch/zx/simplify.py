"""Parameter-safe full reduction of parametric ZX diagrams.

Drives the rewrite rules of :mod:`tsim_tpu_torch.zx.rules` to a fixpoint, in the
spirit of pyzx's ``full_reduce`` but designed around our rule set:

    1. ``to_gh``: all spiders become Z, edge types toggled.
    2. Fixpoint of {fusion, identity removal, terminal collection, copy,
       local complementation, pivot}.
    3. Gadget formation: non-Clifford interior spiders are unfused into
       phase gadgets so that the Clifford residue can pivot ("pivot_gadget").
    4. Gadget fusion: gadgets over identical target sets merge.

Every pass preserves the diagram tensor exactly (including the symbolic
scalar) for every boolean parameter assignment; see tests/unit/zx.
"""

from __future__ import annotations

from fractions import Fraction

from .graph import BOUNDARY, HADAMARD, SIMPLE, Z, ZXGraph
from . import rules

F0 = Fraction(0)
F1 = Fraction(1)


def _is_clifford_phase(p: Fraction) -> bool:
    return p.denominator <= 2


def _is_pauli_phase(p: Fraction) -> bool:
    return p.denominator == 1


def is_gadget_hub(g: ZXGraph, v: int) -> bool:
    """A hub is a phase-free interior spider with exactly one unary neighbor."""
    if g.type(v) != Z or g.phase(v) != 0 or g.get_params(v):
        return False
    if v in g._bset:
        return False
    leaves = [n for n in g.neighbors(v) if g.degree(n) == 1 and g.type(n) == Z]
    return len(leaves) >= 1 and g.degree(v) >= 2


def unfuse_to_gadget(g: ZXGraph, v: int) -> tuple[int, int]:
    """Move v's phase+params onto a fresh gadget (hub + leaf) attached to v.

    Tensor-exact with no scalar change (verified):
    v(a) == v(0) --H-- hub(0) --H-- leaf(a).
    """
    q, r = g.qubit(v), g.row(v)
    hub = g.add_vertex(Z, qubit=q - 0.5, row=r)
    leaf = g.add_vertex(Z, qubit=q - 1, row=r, phase=g.phase(v))
    g.set_params(leaf, g.get_params(v))
    g.set_phase(v, 0)
    g.set_params(v, ())
    g.add_edge((v, hub), HADAMARD)
    g.add_edge((hub, leaf), HADAMARD)
    return hub, leaf


def _basic_fixpoint(g: ZXGraph) -> bool:
    """Fuse + identity-removal to a fixpoint (restores graph-like form)."""
    any_change = False
    while True:
        changed = rules.fuse_spiders(g)
        changed |= rules.remove_identities(g)
        if not changed:
            return any_change
        any_change = True


def interior_clifford_simp(g: ZXGraph) -> bool:
    """Fixpoint of the basic rules. Returns True if anything changed.

    lcomp/pivot assume graph-like form (no interior simple edges), so the
    fuse/identity fixpoint runs before each matcher pass.
    """
    any_change = rules.to_gh(g)
    while True:
        changed = _basic_fixpoint(g)
        changed |= rules.collect_terminals(g)
        _basic_fixpoint(g)
        changed |= rules.copy_rule(g)
        _basic_fixpoint(g)
        changed |= rules.lcomp_matcher(g)
        _basic_fixpoint(g)
        changed |= rules.pivot_matcher(g)
        if g.scalar.is_zero:
            return True
        if not changed:
            return any_change
        any_change = True


def _clear_to_zero(g: ZXGraph) -> None:
    """Zero scalar: drop all interior structure (keep boundaries + wires)."""
    # Keep the graph as-is; downstream checks scalar.is_zero.


def pivot_gadget_simp(g: ZXGraph, allow_hubs: bool = False) -> bool:
    """Enable pivots next to non-Clifford spiders by unfusing them to gadgets.

    For an interior Pauli-phase spider u adjacent (via H) to an interior
    non-Clifford (or parametric non-Pauli) spider v: unfuse v's phase into a
    gadget, then pivot (u, v).

    ``allow_hubs`` permits pivots that release gadget leaves — individually
    valid but non-terminating as a fixpoint rule; used only inside the
    bounded ``_shake`` pass of :func:`full_reduce`.
    """
    changed = False
    for u in list(g.vertices()):
        if u not in g.types():
            continue
        if not rules._interior(g, u) or not rules._all_h_edges(g, u):
            continue
        if g.phase(u) not in (F0, F1):
            continue
        if not allow_hubs and rules._has_gadget_leaf(g, u):
            continue  # pivoting a hub releases its leaf: endless churn
        for v in list(g.neighbors(u)):
            if v not in g.types() or not rules._interior(g, v):
                continue
            if not rules._all_h_edges(g, v):
                continue
            if g.edge_type((u, v)) != HADAMARD:
                continue
            if g.phase(v) in (F0, F1):
                continue  # plain pivot handles it
            if g.degree(v) == 1:
                continue  # already a gadget leaf
            if not allow_hubs and rules._has_gadget_leaf(g, v):
                continue
            unfuse_to_gadget(g, v)
            rules.pivot(g, u, v)
            changed = True
            break
    return changed


def boundary_pivot_simp(g: ZXGraph) -> bool:
    """Pivot where one vertex touches a boundary, by splitting the boundary
    wire with an identity pair so the pivot partner becomes interior.

    For interior Pauli u adjacent via H to spider v that has boundary
    neighbors: insert two spiders on each boundary wire of v, making v
    interior, then pivot if v is Pauli (else unfuse first).
    """
    changed = False
    for u in list(g.vertices()):
        if u not in g.types():
            continue
        if not rules._interior(g, u) or not rules._all_h_edges(g, u):
            continue
        if g.phase(u) not in (F0, F1):
            continue
        if rules._has_gadget_leaf(g, u):
            continue
        for v in list(g.neighbors(u)):
            if v not in g.types():
                continue
            if g.type(v) != Z or v in g._bset:
                continue
            if g.edge_type((u, v)) != HADAMARD:
                continue
            # A hub may pivot against its own Pauli leaf (consumes the
            # gadget); other hub pivots release leaves (churn).
            if rules._has_gadget_leaf(g, v) and g.degree(u) != 1:
                continue
            bnd = [n for n in g.neighbors(v) if g.type(n) == BOUNDARY]
            if not bnd:
                continue
            if any(
                g.edge_type((v, n)) != HADAMARD
                for n in g.neighbors(v)
                if g.type(n) != BOUNDARY
            ):
                continue
            # Split each boundary wire: v --t-- b  =>  v --H-- w --t'-- b
            # where inserting identity pair keeps the tensor: insert spider w
            # (phase 0) with H edge to v; edge w-b gets type toggled(t).
            for b in bnd:
                t = g.edge_type((v, b))
                g.remove_edge((v, b))
                w = g.add_vertex(Z, qubit=g.qubit(b), row=(g.row(v) + g.row(b)) / 2)
                w2 = g.add_vertex(
                    Z, qubit=g.qubit(b), row=(g.row(v) + 2 * g.row(b)) / 3
                )
                g.add_edge((v, w), HADAMARD)
                g.add_edge((w, w2), HADAMARD)
                g.add_edge((w2, b), t)
            if g.phase(v) not in (F0, F1):
                unfuse_to_gadget(g, v)
            rules.pivot(g, u, v)
            changed = True
            break
        if changed:
            break
    return changed


def gadget_simp(g: ZXGraph) -> bool:
    """Fuse phase gadgets with identical target sets.

    Two gadgets (hub1, leaf1), (hub2, leaf2) with N(hub1)-{leaf1} ==
    N(hub2)-{leaf2}: leaves' phases add; scalar sqrt(2)^2 (verified by
    oracle: removing one hub+leaf pair against the shared targets).
    """
    changed = False
    hubs: dict[frozenset, tuple[int, int]] = {}
    for v in list(g.vertices()):
        if v not in g.types():
            continue
        if g.type(v) != Z or g.phase(v) != 0 or g.get_params(v):
            continue
        if v in g._bset:
            continue
        nbrs = g.neighbors(v)
        leaves = [
            n
            for n in nbrs
            if g.degree(n) == 1
            and g.type(n) == Z
            and g.edge_type((v, n)) == HADAMARD
            and n not in g._bset
        ]
        if len(leaves) != 1 or len(nbrs) < 2:
            continue
        if not rules._all_h_edges(g, v):
            continue
        leaf = leaves[0]
        targets = frozenset(n for n in nbrs if n != leaf)
        if any(g.type(t) == BOUNDARY for t in targets):
            continue
        if targets in hubs:
            hub0, leaf0 = hubs[targets]
            # Merge this gadget into gadget0.
            g.add_to_phase(leaf0, g.phase(leaf))
            g.xor_params(leaf0, g.get_params(leaf))
            g.remove_vertex(leaf)
            g.remove_vertex(v)
            # sqrt(2)^(1-k) for k shared targets (dev/calibrate_gadget.py).
            g.scalar.add_power(1 - len(targets))
            changed = True
        else:
            hubs[targets] = (v, leaf)
    return changed


def _signature(g: ZXGraph):
    """Cheap structural fingerprint for rewrite-cycle detection."""
    verts = tuple(
        sorted(
            (str(g.phase(v)), tuple(sorted(g.get_params(v))), g.degree(v), g.type(v))
            for v in g.vertices()
        )
    )
    s = g.scalar
    return (
        g.num_vertices(),
        g.num_edges(),
        verts,
        s.power2,
        str(s.phase),
        len(s.phasenodes),
        len(s.phasepairs),
        len(s.phasevars_pi_pair),
        sum(len(v) for v in s.phasevars_halfpi.values()),
    )


def _nonclifford_count(g: ZXGraph) -> int:
    return sum(1 for v in g.vertices() if g.phase(v).denominator > 2)


# Shake (bounded hub-releasing pivots) is a heuristic: it shrinks some
# decompositions and grows others. The pipeline compiles each plugged
# circuit with shake on and off and keeps the smaller (compile/pipeline.py).
_SHAKE_ENABLED = True


def set_shake(enabled: bool) -> bool:
    global _SHAKE_ENABLED
    prev = _SHAKE_ENABLED
    _SHAKE_ENABLED = enabled
    return prev


def _shake(g: ZXGraph, rounds: int = 30) -> None:
    """Bounded hub-releasing passes, keeping only strict improvements.

    Hub pivots are tensor-exact but non-terminating as fixpoint rules (the
    released leaf re-forms a gadget elsewhere). Run one permissive pass at a
    time and keep the result only when it strictly shrinks
    (non-Clifford count, vertices, edges); otherwise revert and stop.
    """
    for _ in range(rounds):
        before = (_nonclifford_count(g), g.num_vertices(), g.num_edges())
        snap = g.copy()
        changed = pivot_gadget_simp(g, allow_hubs=True)
        if changed:
            interior_clifford_simp(g)
            gadget_simp(g)
            interior_clifford_simp(g)
        after = (_nonclifford_count(g), g.num_vertices(), g.num_edges())
        if not changed or after >= before:
            if after > before:
                g.__dict__.update(snap.__dict__)
            return


def full_reduce(g: ZXGraph, paramSafe: bool = True, quiet: bool = True) -> None:
    """Reduce ``g`` as far as possible, preserving the tensor exactly.

    All passes are individually tensor-exact, so terminating at any point is
    sound. Fixpoint rules exclude gadget hubs (termination); a bounded
    ``_shake`` pass then explores hub-releasing pivots, kept only when they
    strictly shrink the diagram.

    Dispatches to the native C++ engine (:mod:`tsim_tpu_torch.zx.native_simplify`)
    when available; falls back to the Python rules below on any unsupported
    construct. Both paths implement the same rule system.
    """
    from .native_simplify import native_full_reduce

    if native_full_reduce(g, _SHAKE_ENABLED):
        return
    interior_clifford_simp(g)
    for _ in range(1000):
        changed = pivot_gadget_simp(g)
        if changed:
            interior_clifford_simp(g)
        c2 = gadget_simp(g)
        if c2:
            interior_clifford_simp(g)
        c3 = boundary_pivot_simp(g)
        if c3:
            interior_clifford_simp(g)
        if not (changed or c2 or c3):
            break
    if _SHAKE_ENABLED:
        _shake(g)
    g.normalize()
