"""Oracle tests for stabilizer-rank decomposition rules.

Every decomposition must satisfy: tensor(g) == sum_k tensor(term_k) for all
boolean parameter assignments (the reference validates its pyzx-param
decompositions the same way; reference ``test/integration`` strategy).
"""

import itertools
from fractions import Fraction

import numpy as np
import pytest

from tsim_tpu_torch.zx.decompose import (
    cut_vertex,
    replace_magic_states,
    replace_u3_states,
    split_conjugate_pair,
    split_doubled_state_pair,
    split_t_pair,
    tcount,
    u3_count,
)
from tsim_tpu_torch.zx.graph import BOUNDARY, HADAMARD, SIMPLE, Z, ZXGraph
from tsim_tpu_torch.zx.tensor import graph_to_tensor

PARAMS = ["e0", "e1"]
ASSIGN = [dict(zip(PARAMS, b)) for b in itertools.product([0, 1], repeat=2)]
THETA = Fraction(3, 10)


def assert_sum_equiv(g, gsum, atol=1e-8):
    for vals in ASSIGN:
        tb = np.asarray(graph_to_tensor(g, vals=vals))
        ta = sum(
            np.asarray(graph_to_tensor(gg, vals=vals))
            for gg in gsum.graphs
            if not gg.scalar.is_zero
        )
        np.testing.assert_allclose(tb, ta, atol=atol)


def _random_clifford_core(rng, g, n=4):
    vs = []
    for _ in range(n):
        ph = [0, Fraction(1, 4), Fraction(1, 2), Fraction(1)][rng.integers(0, 4)]
        v = g.add_vertex(Z, phase=ph)
        if rng.random() < 0.4:
            g.set_params(v, {PARAMS[rng.integers(0, 2)]})
        vs.append(v)
    for a, b in itertools.combinations(vs, 2):
        if rng.random() < 0.4:
            g.add_edge((a, b), HADAMARD)
    return vs


def _add_boundaries(rng, g, anchors, k=2):
    outs = []
    for _ in range(k):
        b = g.add_vertex(BOUNDARY)
        t = anchors[int(rng.integers(0, len(anchors)))]
        if not g.connected(b, t):
            g.add_edge((b, t), HADAMARD)
            outs.append(b)
    g.set_outputs(outs)


class TestConjugatePair:
    @pytest.mark.parametrize("seed", range(8))
    def test_random_graphs(self, seed):
        rng = np.random.default_rng(seed)
        g = ZXGraph()
        vs = _random_clifford_core(rng, g)
        v1 = g.add_vertex(Z, phase=THETA)
        v2 = g.add_vertex(Z, phase=(-THETA) % 2)
        if seed % 2:
            g.set_params(v1, {PARAMS[0]})
            g.set_params(v2, {PARAMS[1]})
        for a in vs:
            for v in (v1, v2):
                if rng.random() < 0.5:
                    g.add_edge((a, v), HADAMARD)
        if seed % 3 == 0:
            g.add_edge((v1, v2), HADAMARD)
        _add_boundaries(rng, g, vs)
        assert_sum_equiv(g, split_conjugate_pair(g.copy(), v1, v2))

    def test_sum_to_half_pair(self):
        """Phases summing to a non-zero Clifford angle also split exactly."""
        g = ZXGraph()
        anchor = g.add_vertex(Z, phase=Fraction(1, 4))
        v1 = g.add_vertex(Z, phase=THETA)
        v2 = g.add_vertex(Z, phase=(Fraction(1, 2) - THETA) % 2)
        g.add_edge((anchor, v1), HADAMARD)
        g.add_edge((anchor, v2), HADAMARD)
        out = g.add_vertex(BOUNDARY)
        g.add_edge((anchor, out), HADAMARD)
        g.set_outputs([out])
        assert_sum_equiv(g, split_conjugate_pair(g.copy(), v1, v2))


class TestDoubledStatePair:
    @pytest.mark.parametrize("seed", range(8))
    @pytest.mark.parametrize(
        "host_phase", [Fraction(1, 4), Fraction(3, 4), Fraction(1, 2), Fraction(0)]
    )
    def test_random_graphs(self, seed, host_phase):
        rng = np.random.default_rng(seed)
        g = ZXGraph()
        vs = _random_clifford_core(rng, g)
        h1 = g.add_vertex(Z, phase=host_phase)
        h2 = g.add_vertex(Z, phase=(-host_phase) % 2)
        if rng.random() < 0.5:
            g.set_params(h1, {PARAMS[0]})
        if rng.random() < 0.5:
            g.set_params(h2, {PARAMS[1]})
        l1 = g.add_vertex(Z, phase=THETA)
        l2 = g.add_vertex(Z, phase=(-THETA) % 2)
        if seed % 3 == 0:
            g.set_params(l1, {PARAMS[0]})
            g.set_params(l2, {PARAMS[0]})
        g.add_edge((l1, h1), HADAMARD)
        g.add_edge((l2, h2), HADAMARD)
        for h in (h1, h2):
            for v in vs:
                if rng.random() < 0.6:
                    g.add_edge((h, v), HADAMARD)
        _add_boundaries(rng, g, vs + [h1, h2])
        assert_sum_equiv(g, split_doubled_state_pair(g.copy(), l1, h1, l2, h2))


class TestTPair:
    @pytest.mark.parametrize("seed", range(6))
    def test_random_graphs(self, seed):
        rng = np.random.default_rng(seed)
        g = ZXGraph()
        vs = _random_clifford_core(rng, g)
        phases = [Fraction(k, 4) for k in (1, 3, 5, 7)]
        v1 = g.add_vertex(Z, phase=phases[seed % 4])
        v2 = g.add_vertex(Z, phase=phases[(seed + 1) % 4])
        for a in vs:
            for v in (v1, v2):
                if rng.random() < 0.5:
                    g.add_edge((a, v), HADAMARD)
        _add_boundaries(rng, g, vs)
        assert_sum_equiv(g, split_t_pair(g.copy(), v1, v2))


class TestDrivers:
    def test_replace_u3_prefers_motif(self):
        """The doubled-state motif yields 3 branches with both T hosts gone."""
        g = ZXGraph()
        core = g.add_vertex(Z)
        h1 = g.add_vertex(Z, phase=Fraction(1, 4))
        h2 = g.add_vertex(Z, phase=Fraction(7, 4))
        l1 = g.add_vertex(Z, phase=THETA)
        l2 = g.add_vertex(Z, phase=(-THETA) % 2)
        g.add_edge((l1, h1), HADAMARD)
        g.add_edge((l2, h2), HADAMARD)
        g.add_edge((h1, core), HADAMARD)
        g.add_edge((h2, core), HADAMARD)
        gsum = replace_u3_states(g.copy())
        assert len(gsum.graphs) == 3
        assert all(u3_count(gg) == 0 for gg in gsum.graphs)
        assert all(tcount(gg) == 0 for gg in gsum.graphs)
        assert_sum_equiv(g, gsum)

    def test_replace_u3_falls_back_to_cut(self):
        g = ZXGraph()
        v = g.add_vertex(Z, phase=THETA)
        out = g.add_vertex(BOUNDARY)
        g.add_edge((v, out), HADAMARD)
        g.set_outputs([out])
        gsum = replace_u3_states(g.copy())
        assert len(gsum.graphs) == 2
        assert_sum_equiv(g, gsum)

    def test_cut_vertex_exact_dyadic(self):
        g = ZXGraph()
        v = g.add_vertex(Z, phase=Fraction(1, 4), phaseVars=["e0"])
        out = g.add_vertex(BOUNDARY)
        g.add_edge((v, out), HADAMARD)
        g.set_outputs([out])
        assert_sum_equiv(g, cut_vertex(g.copy(), v))


class TestBss6:
    """Real BSS 6T -> 7 split (reference strategy="bss" semantics,
    reference ``tsim/compile/stabrank.py:38-52``)."""

    @pytest.mark.parametrize("seed", range(10))
    def test_random_graphs(self, seed):
        from tsim_tpu_torch.zx.decompose import split_bss6

        rng = np.random.default_rng(seed)
        g = ZXGraph()
        vs = _random_clifford_core(rng, g)
        magic = []
        for k in range(6):
            ph = Fraction([1, 3, 5, 7][rng.integers(0, 4)], 4)
            v = g.add_vertex(Z, phase=ph)
            if rng.random() < 0.4:
                g.set_params(v, {PARAMS[rng.integers(0, 2)]})
            magic.append(v)
        for a in vs:
            for v in magic:
                if rng.random() < 0.4 and not g.connected(a, v):
                    g.add_edge((a, v), HADAMARD)
        # also connect some magic pairs directly (exercises parallel-edge
        # resolution when the triangle lands on an existing H edge)
        for a, b in itertools.combinations(magic, 2):
            if rng.random() < 0.2:
                g.add_edge((a, b), HADAMARD)
        _add_boundaries(rng, g, vs + magic)
        gsum = split_bss6(g.copy(), magic)
        assert len(gsum.graphs) == 7
        assert_sum_equiv(g, gsum)
        # every branch removed all six magic phases
        for gg in gsum.graphs:
            assert sum(1 for v in magic if v in set(gg.vertices())
                       and gg.phase(v).denominator == 4) == 0

    def test_replace_magic_states_bss_uses_bss6(self):
        g = ZXGraph()
        anchor = g.add_vertex(Z)
        for _ in range(6):
            v = g.add_vertex(Z, phase=Fraction(1, 4))
            g.add_edge((anchor, v), HADAMARD)
        out = g.add_vertex(BOUNDARY)
        g.add_edge((anchor, out), HADAMARD)
        g.set_outputs([out])
        gsum = replace_magic_states(g.copy(), strategy="bss")
        assert len(gsum.graphs) == 7
        assert_sum_equiv(g, gsum)

    def test_find_stab_bss_term_scaling(self):
        """12 T phases -> at most 7^2 = 49 terms pre-merge via BSS."""
        from tsim_tpu_torch.compile.stabrank import find_stab

        g = ZXGraph()
        anchors = [g.add_vertex(Z) for _ in range(3)]
        for k in range(12):
            v = g.add_vertex(Z, phase=Fraction(1, 4))
            g.add_edge((anchors[k % 3], v), HADAMARD)
        outs = []
        for a in anchors:
            b = g.add_vertex(BOUNDARY)
            g.add_edge((a, b), HADAMARD)
            outs.append(b)
        g.set_outputs(outs)
        ref = graph_to_tensor(g)
        terms = find_stab(g.copy(), strategy="bss")
        assert len(terms) <= 49
        total = sum(np.asarray(graph_to_tensor(t)) for t in terms)
        np.testing.assert_allclose(np.asarray(ref), total, atol=1e-8)


class TestConjugateGadgetPair:
    @pytest.mark.parametrize("seed", range(10))
    def test_random_graphs(self, seed):
        from tsim_tpu_torch.zx.decompose import split_conjugate_gadget_pair

        rng = np.random.default_rng(seed)
        g = ZXGraph()
        nS = int(rng.integers(1, 4))
        S = [
            g.add_vertex(Z, phase=[0, Fraction(1, 2), Fraction(1)][rng.integers(0, 3)])
            for _ in range(nS)
        ]
        a = g.add_vertex(Z, phase=[0, Fraction(1, 2)][rng.integers(0, 2)])
        b = g.add_vertex(Z, phase=[0, Fraction(3, 2)][rng.integers(0, 2)])
        if seed % 4 == 0:
            g.set_params(a, {PARAMS[0]})
        alpha = [Fraction(1, 4), Fraction(3, 4), THETA][seed % 3]
        P = frozenset({PARAMS[0]}) if seed % 3 == 0 else frozenset()
        Q = frozenset({PARAMS[1]}) if seed % 2 == 0 else frozenset()
        h1 = g.add_vertex(Z)
        g.set_params(h1, Q)
        h2 = g.add_vertex(Z)
        g.set_params(h2, Q)
        l1 = g.add_vertex(Z, phase=alpha)
        g.set_params(l1, P)
        l2 = g.add_vertex(Z, phase=(-alpha) % 2)
        g.set_params(l2, P)
        g.add_edge((l1, h1), HADAMARD)
        g.add_edge((l2, h2), HADAMARD)
        for t in S:
            g.add_edge((h1, t), HADAMARD)
            g.add_edge((h2, t), HADAMARD)
        g.add_edge((h1, a), HADAMARD)
        g.add_edge((h2, b), HADAMARD)
        for u, v in itertools.combinations(S + [a, b], 2):
            if rng.random() < 0.3:
                g.add_edge((u, v), HADAMARD)
        _add_boundaries(rng, g, S + [a, b])
        assert_sum_equiv(
            g, split_conjugate_gadget_pair(g.copy(), l1, h1, l2, h2, a, b)
        )


class TestGadgetPairProjector:
    """2-term projector split for conjugate / same-phase gadget pairs."""

    def _build(self, rng, conjugate, overlap, with_params, hub_params):
        from tsim_tpu_torch.zx.decompose import split_gadget_pair_projector

        g = ZXGraph()
        vs = _random_clifford_core(rng, g, n=5)
        t1 = [vs[i] for i in (0, 1, 2)]
        t2 = [vs[i] for i in ((1, 2, 3) if overlap else (3, 4))]
        a1 = Fraction(1, 4)
        # "conjugate" pairs sum to 0; otherwise any odd pi/4 partner works
        # (sum and difference are always Clifford for odd eighth-turns).
        a2 = (-a1) % 2 if conjugate else Fraction(3, 4)
        h1 = g.add_vertex(Z)
        l1 = g.add_vertex(Z, phase=a1)
        h2 = g.add_vertex(Z)
        l2 = g.add_vertex(Z, phase=a2)
        if with_params:
            g.set_params(l1, {PARAMS[0]})
            g.set_params(l2, {PARAMS[1]})  # unequal leaf params
        if hub_params:
            g.set_params(h1, {PARAMS[0]})
            g.set_params(h2, {PARAMS[1]})
        g.add_edge((l1, h1), HADAMARD)
        g.add_edge((l2, h2), HADAMARD)
        for t in t1:
            g.add_edge((h1, t), HADAMARD)
        for t in t2:
            g.add_edge((h2, t), HADAMARD)
        _add_boundaries(rng, g, vs)
        return g, (l1, h1, l2, h2), split_gadget_pair_projector

    @pytest.mark.parametrize("seed", range(4))
    @pytest.mark.parametrize("conjugate", [True, False])
    @pytest.mark.parametrize("overlap", [True, False])
    @pytest.mark.parametrize("with_params", [True, False])
    def test_random_graphs(self, seed, conjugate, overlap, with_params):
        rng = np.random.default_rng(seed + 100)
        g, motif, split = self._build(
            rng, conjugate, overlap, with_params, hub_params=seed % 2 == 0
        )
        gsum = split(g.copy(), *motif)
        assert len(gsum.graphs) == 2
        base_t = tcount(g)
        assert all(tcount(gg) == base_t - 2 for gg in gsum.graphs)
        assert_sum_equiv(g, gsum)

    def test_identical_supports(self):
        """T1 == T2 gives an empty symdiff: projector is a bare scalar node."""
        from tsim_tpu_torch.zx.decompose import split_gadget_pair_projector

        rng = np.random.default_rng(7)
        g = ZXGraph()
        vs = _random_clifford_core(rng, g, n=3)
        h1 = g.add_vertex(Z)
        l1 = g.add_vertex(Z, phase=Fraction(1, 4))
        h2 = g.add_vertex(Z)
        l2 = g.add_vertex(Z, phase=Fraction(7, 4))
        g.add_edge((l1, h1), HADAMARD)
        g.add_edge((l2, h2), HADAMARD)
        for t in vs:
            g.add_edge((h1, t), HADAMARD)
            g.add_edge((h2, t), HADAMARD)
        _add_boundaries(rng, g, vs)
        assert_sum_equiv(g, split_gadget_pair_projector(g.copy(), l1, h1, l2, h2))


class TestGadgetize:
    @pytest.mark.parametrize("seed", range(6))
    def test_unfuse_identity(self, seed):
        """Z_E(a + pi P) == Z_E(0) --H-- Z(0) --H-- Z_1(a + pi P), exactly."""
        from tsim_tpu_torch.zx.decompose import gadgetize_magic

        rng = np.random.default_rng(seed)
        g = ZXGraph()
        vs = _random_clifford_core(rng, g, n=5)
        for v in vs[:3]:
            g.set_phase(v, [Fraction(1, 4), Fraction(7, 4)][int(rng.integers(2))])
        _add_boundaries(rng, g, vs)
        g2 = g.copy()
        assert gadgetize_magic(g2)
        for vals in ASSIGN:
            np.testing.assert_allclose(
                np.asarray(graph_to_tensor(g, vals=vals)),
                np.asarray(graph_to_tensor(g2, vals=vals)),
                atol=1e-8,
            )


class TestApplyPairProjector:
    @pytest.mark.parametrize("seed", range(8))
    def test_branches_sum(self, seed):
        """c=0 plus c=1 branches of the in-place projector split sum to the
        original diagram (the GraphSum wrapper delegates to the in-place
        form, so this pins both)."""
        from tsim_tpu_torch.zx.decompose import (
            _find_projector_gadget_pair,
            _t_vertices,
            split_gadget_pair_projector,
        )

        rng = np.random.default_rng(seed)
        g = ZXGraph()
        vs = _random_clifford_core(rng, g, n=4)
        for k in range(2):
            hub = g.add_vertex(Z)
            leaf = g.add_vertex(
                Z, phase=[Fraction(1, 4), Fraction(7, 4)][int(rng.integers(2))]
            )
            if rng.random() < 0.5:
                g.set_params(leaf, {PARAMS[int(rng.integers(2))]})
            if rng.random() < 0.5:
                g.set_params(hub, {PARAMS[int(rng.integers(2))]})
            g.add_edge((hub, leaf), HADAMARD)
            for t in rng.permutation(vs)[: 2 + k]:
                g.add_edge((hub, int(t)), HADAMARD)
        _add_boundaries(rng, g, vs)
        motif = _find_projector_gadget_pair(g, _t_vertices(g), strict=False)
        assert motif is not None
        assert_sum_equiv(g, split_gadget_pair_projector(g.copy(), *motif))


class TestPlannedDecomposition:
    @pytest.mark.parametrize("seed", range(10))
    def test_oracle(self, seed):
        """Planned joint decomposition sums exactly to the original tensor
        for every parameter assignment."""
        from tsim_tpu_torch.zx.decompose import planned_magic_decomposition

        rng = np.random.default_rng(seed)
        g = ZXGraph()
        vs = _random_clifford_core(rng, g, n=5)
        for v in vs[:4]:
            g.set_phase(
                v, [Fraction(1, 4), Fraction(3, 4), Fraction(5, 4)][int(rng.integers(3))]
            )
        for k in range(2):
            hub = g.add_vertex(Z)
            leaf = g.add_vertex(
                Z, phase=[Fraction(1, 4), Fraction(7, 4)][int(rng.integers(2))]
            )
            if rng.random() < 0.5:
                g.set_params(leaf, {PARAMS[int(rng.integers(2))]})
            g.add_edge((hub, leaf), HADAMARD)
            for t in rng.permutation(vs)[: 2 + k]:
                g.add_edge((hub, int(t)), HADAMARD)
        _add_boundaries(rng, g, vs)
        leaves = planned_magic_decomposition(g, max_rank=14, restarts=4)
        if leaves is None:
            pytest.skip("planner declined (too few pairable gadgets)")
        for vals in ASSIGN:
            tb = np.asarray(graph_to_tensor(g, vals=vals))
            ta = sum(
                np.asarray(graph_to_tensor(gg, vals=vals)) for gg in leaves
            ) if leaves else np.zeros_like(tb)
            np.testing.assert_allclose(tb, ta, atol=1e-8)

    def test_all_leaves_clifford_on_cultivation_shape(self):
        """Paired mirror gadgets (the doubled-diagram motif) decompose with
        zero residual magic and 2^rank leaves."""
        from tsim_tpu_torch.zx.decompose import planned_magic_decomposition

        g = ZXGraph()
        body = [g.add_vertex(Z) for _ in range(4)]
        for a, b in itertools.combinations(body, 2):
            g.add_edge((a, b), HADAMARD)
        # two mirror pairs: supports differ by one shared vertex
        for supports, phase in [
            ((body[0], body[1]), Fraction(1, 4)),
            ((body[0], body[1], body[2]), Fraction(7, 4)),
            ((body[1], body[3]), Fraction(1, 4)),
            ((body[1], body[2], body[3]), Fraction(7, 4)),
        ]:
            hub = g.add_vertex(Z)
            leaf = g.add_vertex(Z, phase=phase)
            g.add_edge((hub, leaf), HADAMARD)
            for t in supports:
                g.add_edge((hub, t), HADAMARD)
        _add_boundaries(np.random.default_rng(0), g, body)
        leaves = planned_magic_decomposition(g, max_rank=14, restarts=4)
        assert leaves is not None
        assert all(tcount(gg) == 0 for gg in leaves)
        for vals in ASSIGN:
            tb = np.asarray(graph_to_tensor(g, vals=vals))
            ta = sum(np.asarray(graph_to_tensor(gg, vals=vals)) for gg in leaves)
            np.testing.assert_allclose(tb, ta, atol=1e-8)


class TestPiHubNormalization:
    @pytest.mark.parametrize("seed", range(6))
    def test_identity(self, seed):
        """gadget(a, hub pi) == e^{i pi a} (-1)^P gadget(-a, hub 0):
        gadgetize_magic normalizes pi-phase hubs in place, exactly."""
        from tsim_tpu_torch.zx.decompose import gadgetize_magic

        rng = np.random.default_rng(seed)
        g = ZXGraph()
        vs = _random_clifford_core(rng, g, n=4)
        hub = g.add_vertex(Z, phase=Fraction(1))
        leaf = g.add_vertex(
            Z, phase=[Fraction(1, 4), Fraction(3, 4), Fraction(7, 4)][seed % 3]
        )
        if seed % 2:
            g.set_params(leaf, {PARAMS[0]})
        g.add_edge((hub, leaf), HADAMARD)
        for t in rng.permutation(vs)[:2]:
            g.add_edge((hub, int(t)), HADAMARD)
        _add_boundaries(rng, g, vs)
        g2 = g.copy()
        gadgetize_magic(g2)
        assert g2.phase(hub) == 0
        for vals in ASSIGN:
            np.testing.assert_allclose(
                np.asarray(graph_to_tensor(g, vals=vals)),
                np.asarray(graph_to_tensor(g2, vals=vals)),
                atol=1e-8,
            )


class TestDecompositionBudget:
    def test_budget_aborts(self):
        from tsim_tpu_torch.compile.stabrank import (
            DecompositionBudgetExceeded,
            find_stab,
        )

        g = ZXGraph()
        vs = [g.add_vertex(Z, phase=Fraction(1, 4)) for _ in range(8)]
        for a, b in itertools.combinations(vs, 2):
            g.add_edge((a, b), HADAMARD)
        with pytest.raises(DecompositionBudgetExceeded):
            find_stab(g.copy(), strategy="cutting", max_terms=1)
        # and without a budget the same decomposition completes
        assert find_stab(g.copy(), strategy="cutting", max_terms=None)


class TestPlannerStalePairFilter:
    """Regression: r1 HEAD remapped plan vectors to integer coordinate ranks
    but left the stale-pair filter comparing ranks against vertex ids, so
    every pair passed and apply_pair_projector KeyError'd on removed hubs
    (broke d3/d5 distillation + cultivation compiles)."""

    def _gadget_graph(self, seed, n_gadgets=5):
        from tsim_tpu_torch.zx.decompose import _projector_gadgets, _t_vertices

        rng = np.random.default_rng(seed)
        g = ZXGraph()
        body = _random_clifford_core(rng, g, n=5)
        hubs = []
        for k in range(n_gadgets):
            hub = g.add_vertex(Z)
            leaf = g.add_vertex(
                Z, phase=[Fraction(1, 4), Fraction(7, 4)][int(rng.integers(2))]
            )
            if rng.random() < 0.5:
                g.set_params(leaf, {PARAMS[int(rng.integers(2))]})
            g.add_edge((hub, leaf), HADAMARD)
            for t in rng.permutation(body)[: 2 + (k % 2)]:
                g.add_edge((hub, int(t)), HADAMARD)
            # Hub-to-hub edges make other gadgets' hubs appear inside
            # support symdiffs, which is what the stale-pair filter guards.
            if hubs and rng.random() < 0.7:
                g.add_edge((hub, hubs[int(rng.integers(len(hubs)))]), HADAMARD)
            hubs.append(hub)
        _add_boundaries(rng, g, body)
        return g, _projector_gadgets(g, _t_vertices(g))

    @pytest.mark.parametrize("seed", range(12))
    def test_chosen_pairs_never_reference_removed_vertices(self, seed):
        from tsim_tpu_torch.zx.decompose import plan_projector_cover

        g, gadgets = self._gadget_graph(seed)
        if len(gadgets) < 4:
            pytest.skip("not enough eligible gadgets")
        pairs = plan_projector_cover(g, gadgets, restarts=6)
        removed = set()
        for i, j, _ in pairs:
            for k in (i, j):
                removed |= {gadgets[k][0], gadgets[k][1]}
        for i, j, _ in pairs:
            own = {gadgets[i][0], gadgets[i][1], gadgets[j][0], gadgets[j][1]}
            symdiff = gadgets[i][2] ^ gadgets[j][2]
            assert not (symdiff & (removed - own)), (
                f"pair ({i},{j}) references vertices removed by another pair"
            )

    @pytest.mark.parametrize("seed", range(6))
    def test_planned_decomposition_oracle_with_hub_hub_edges(self, seed):
        from tsim_tpu_torch.zx.decompose import planned_magic_decomposition

        g, gadgets = self._gadget_graph(seed)
        leaves = planned_magic_decomposition(g, max_rank=14, restarts=4)
        if leaves is None:
            pytest.skip("planner declined")
        for vals in ASSIGN:
            tb = np.asarray(graph_to_tensor(g, vals=vals))
            ta = sum(np.asarray(graph_to_tensor(gg, vals=vals)) for gg in leaves)
            np.testing.assert_allclose(tb, ta, atol=1e-8)


class TestNativePlannedEnumeration:
    """The C++ leaf enumerator (zx_planned_enumerate) must agree with the
    Python per-leaf loop graph-for-graph: same survivors, same reduced
    state, same scalars."""

    @pytest.mark.parametrize("seed", range(8))
    def test_matches_python_loop(self, seed, monkeypatch):
        from tsim_tpu_torch.compile.stabrank import _graph_state_key
        from tsim_tpu_torch.zx import native_simplify as ns
        from tsim_tpu_torch.zx.decompose import planned_magic_decomposition

        if ns._load() is None:
            pytest.skip("native engine unavailable")

        rng = np.random.default_rng(1000 + seed)
        g = ZXGraph()
        vs = _random_clifford_core(rng, g, n=6)
        for v in vs[:4]:
            g.set_phase(
                v,
                [Fraction(1, 4), Fraction(3, 4), Fraction(5, 4)][
                    int(rng.integers(3))
                ],
            )
        for k in range(3):
            hub = g.add_vertex(Z)
            leaf = g.add_vertex(
                Z, phase=[Fraction(1, 4), Fraction(7, 4)][int(rng.integers(2))]
            )
            if rng.random() < 0.5:
                g.set_params(leaf, {PARAMS[int(rng.integers(2))]})
            g.add_edge((hub, leaf), HADAMARD)
            for t in rng.permutation(vs)[: 2 + (k % 2)]:
                g.add_edge((hub, int(t)), HADAMARD)
        _add_boundaries(rng, g, vs)

        native = planned_magic_decomposition(g.copy(), max_rank=14, restarts=8)
        monkeypatch.setattr(
            ns, "native_planned_enumerate", lambda *a, **k: None
        )
        python = planned_magic_decomposition(g.copy(), max_rank=14, restarts=8)
        if native is None or python is None:
            assert native is None and python is None
            pytest.skip("planner declined")
        assert len(native) == len(python)
        kn = sorted(str(_graph_state_key(x)) for x in native)
        kp = sorted(str(_graph_state_key(x)) for x in python)
        assert kn == kp
