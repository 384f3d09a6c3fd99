"""Oracle tests for every ZX rewrite rule (tensor-exact, with parameters)."""

import itertools
from fractions import Fraction

import numpy as np
import pytest

from tsim_tpu_torch.zx import rules, simplify
from tsim_tpu_torch.zx.graph import BOUNDARY, HADAMARD, SIMPLE, X, Z, ZXGraph
from tsim_tpu_torch.zx.tensor import graph_to_tensor

PARAMS = ["e0", "e1", "e2"]
ASSIGNMENTS = [dict(zip(PARAMS, bits)) for bits in itertools.product([0, 1], repeat=3)]


def assert_equiv(g_before, g_after, atol=1e-8):
    for vals in ASSIGNMENTS:
        tb = np.asarray(graph_to_tensor(g_before, vals=vals))
        if g_after.scalar.is_zero:
            ta = np.zeros_like(tb)
        else:
            ta = np.asarray(graph_to_tensor(g_after, vals=vals))
        np.testing.assert_allclose(tb, ta, atol=atol)


def random_graph(rng, n_interior=6, n_boundary=2, p_edge=0.35, p_param=0.3,
                 clifford_only=False):
    phases = [Fraction(k, 4) for k in range(8)] + [Fraction(3, 10)]
    g = ZXGraph()
    interior = []
    for _ in range(n_interior):
        ty = Z if rng.random() < 0.7 else X
        ph = Fraction(int(rng.integers(0, 4)), 2) if clifford_only else phases[rng.integers(0, len(phases))]
        v = g.add_vertex(ty, phase=ph)
        if rng.random() < p_param:
            ps = {PARAMS[i] for i in rng.choice(3, size=int(rng.integers(1, 3)), replace=False)}
            g.set_params(v, ps)
        interior.append(v)
    for a, b in itertools.combinations(interior, 2):
        if rng.random() < p_edge:
            g.add_edge((a, b), HADAMARD if rng.random() < 0.8 else SIMPLE)
    outs = []
    for _ in range(n_boundary):
        b = g.add_vertex(BOUNDARY)
        t = interior[int(rng.integers(0, len(interior)))]
        while g.connected(b, t):
            t = interior[int(rng.integers(0, len(interior)))]
        g.add_edge((b, t), HADAMARD if rng.random() < 0.5 else SIMPLE)
        outs.append(b)
    g.set_outputs(outs)
    return g


class TestLcomp:
    @pytest.mark.parametrize("s", [1, -1])
    @pytest.mark.parametrize("n", [1, 2, 3, 4])
    def test_lcomp_exact(self, s, n):
        rng = np.random.default_rng(n * 10 + s)
        g = ZXGraph()
        u = g.add_vertex(Z, phase=Fraction(s, 2))
        if rng.random() < 0.5:
            g.set_params(u, {"e0"})
        nbrs = [g.add_vertex(Z, phase=Fraction(int(rng.integers(0, 8)), 4)) for _ in range(n)]
        for v in nbrs:
            g.add_edge((u, v), HADAMARD)
            w = g.add_vertex(Z, phase=Fraction(int(rng.integers(0, 8)), 4))
            g.add_edge((v, w), HADAMARD)
        for a, b in itertools.combinations(nbrs, 2):
            if rng.random() < 0.4:
                g.add_edge((a, b), HADAMARD)
        g2 = g.copy()
        rules.lcomp(g2, u)
        assert_equiv(g, g2)


class TestPivot:
    @pytest.mark.parametrize("a0,b0", itertools.product([0, 1], repeat=2))
    def test_pivot_exact_with_params(self, a0, b0):
        rng = np.random.default_rng(a0 * 2 + b0)
        g = ZXGraph()
        u = g.add_vertex(Z, phase=Fraction(a0))
        v = g.add_vertex(Z, phase=Fraction(b0))
        g.set_params(u, {"e0"})
        g.set_params(v, {"e1", "e2"})
        g.add_edge((u, v), HADAMARD)
        groups = []
        for labels in ("AA", "B", "CC"):
            grp = []
            for _ in labels:
                w = g.add_vertex(Z, phase=Fraction(int(rng.integers(0, 8)), 4))
                spect = g.add_vertex(Z, phase=Fraction(int(rng.integers(0, 8)), 4))
                g.add_edge((w, spect), HADAMARD)
                grp.append(w)
            groups.append(grp)
        A, B, C = groups
        for x in A + C:
            g.add_edge((u, x), HADAMARD)
        for x in B + C:
            g.add_edge((v, x), HADAMARD)
        g2 = g.copy()
        rules.pivot(g2, u, v)
        assert_equiv(g, g2)


class TestFullReduce:
    @pytest.mark.parametrize("seed", range(25))
    def test_random_graphs(self, seed):
        rng = np.random.default_rng(seed)
        g = random_graph(
            rng,
            n_interior=int(rng.integers(3, 8)),
            n_boundary=int(rng.integers(0, 3)),
            clifford_only=seed % 3 == 0,
        )
        g2 = g.copy()
        simplify.full_reduce(g2)
        assert_equiv(g, g2)

    def test_clifford_scalar_graphs_fully_reduce(self):
        rng = np.random.default_rng(5)
        for _ in range(10):
            g = random_graph(rng, n_interior=7, n_boundary=0, p_param=0.0,
                             clifford_only=True)
            g2 = g.copy()
            simplify.full_reduce(g2)
            assert g2.num_vertices() == 0

    def test_unfuse_to_gadget_exact(self):
        rng = np.random.default_rng(3)
        g = ZXGraph()
        v = g.add_vertex(Z, phase=Fraction(1, 4))
        g.set_params(v, {"e0"})
        for _ in range(3):
            w = g.add_vertex(Z, phase=Fraction(int(rng.integers(0, 8)), 4))
            g.add_edge((v, w), HADAMARD)
        g2 = g.copy()
        simplify.unfuse_to_gadget(g2, v)
        assert_equiv(g, g2)


class TestCompose:
    def test_compose_adjoint_doubles(self):
        rng = np.random.default_rng(11)
        g = random_graph(rng, n_interior=4, n_boundary=2, p_param=0.3)
        t = np.asarray(graph_to_tensor(g, vals={"e0": 1}))
        ga = g.adjoint()
        ta = np.asarray(graph_to_tensor(ga, vals={"e0": 1}))
        np.testing.assert_allclose(ta, t.conj().T if t.ndim == 2 else ta, atol=1e-8)

    def test_apply_effect(self):
        g = ZXGraph()
        v = g.add_vertex(Z, phase=Fraction(1, 4))
        b = g.add_vertex(BOUNDARY)
        g.add_edge((v, b), SIMPLE)
        g.set_outputs([b])
        t = np.asarray(graph_to_tensor(g))  # state vector (1, e^{i pi/4})
        g0 = g.copy()
        g0.apply_effect("0")
        np.testing.assert_allclose(complex(np.asarray(graph_to_tensor(g0))), t[0], atol=1e-9)
        g1 = g.copy()
        g1.apply_effect("1")
        np.testing.assert_allclose(complex(np.asarray(graph_to_tensor(g1))), t[1], atol=1e-9)
        gp = g.copy()
        gp.apply_effect("+")
        np.testing.assert_allclose(
            complex(np.asarray(graph_to_tensor(gp))), (t[0] + t[1]) / np.sqrt(2), atol=1e-9
        )
