"""The port's f32 sampling evaluator against tsim_tpu's, on the same rows.

The cases follow ``tests/unit/compile/test_pallas_sample.py``: each family
alone, mixed families, several graph counts on both sides of the
small-G cutoff, real circuit rungs and the power-of-two bias fold.
Tolerances: against the exact path as in that file (rtol 1e-4,
atol 1e-6); against tsim_tpu's own f32 kernels (interpret mode) tighter,
since only the f32 summation order differs (rtol 1e-5, atol 1e-7); on d3
distillation's rungs as in ``tests/integration/test_f32_sampling.py``
(rtol 1e-5, atol 1e-8).
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

import tsim_tpu
from tsim_tpu.compile import pallas_sample
from tsim_tpu.compile.compile import compile_scalar_graphs
from tsim_tpu.compile.evaluate import evaluate_abs
from tsim_tpu.zx.graph import ZXGraph
from dev.export_torch_program import compile_d3
from tsim_tpu_torch.compile import evaluate, sample_eval, sample_tables
from tsim_tpu_torch.compile.exact_tables import ExactTables
from tsim_tpu_torch.compile.sample_tables import SampleTables
from tsim_tpu_torch.kernels import sample_eval as kernel
from tsim_tpu_torch.program_io import rung_from_reference


def _scalar_csg(build, params=("f0", "f1")):
    g = ZXGraph()
    build(g.scalar)
    return compile_scalar_graphs([g], list(params))


def _mixed(s):
    s.add_node(0.25, ["f0"])
    s.add_node(0.75, ["f1"])
    s.add_halfpi(3, ["f0"])
    s.add_pi_pair(frozenset({"f0"}), frozenset({"f1"}))
    s.add_phase_pair(1, 7, ["f0"], ["f1"])
    s.add_phase_pair(3, 5, ["f1"], ["f0"])


def _multi_graph(n_graphs):
    graphs = []
    for k in range(1, n_graphs + 1):
        g = ZXGraph()
        for j in range(k % 3 + 1):
            g.scalar.add_node(Fraction(1, 4) * (2 * j + 1), [f"f{j % 2}"])
        if k % 2:
            g.scalar.add_phase_pair(1, 7, ["f0"], ["f1"])
        if k % 5 == 0:
            g.scalar.add_halfpi(k % 8, ["f1"])
        g.scalar.power2 -= k % 3
        graphs.append(g)
    return compile_scalar_graphs(graphs, ["f0", "f1"])


def _bias_graphs(shift):
    graphs = []
    for k in range(30):
        g = ZXGraph()
        g.scalar.add_node(Fraction(1, 4) * (2 * (k % 4) + 1), [f"f{k % 2}"])
        if k % 3 == 0:
            g.scalar.add_phase_pair(1, 7, ["f0"], ["f1"])
        g.scalar.power2 = -85 + (k % 7) + shift
        graphs.append(g)
    return compile_scalar_graphs(graphs, ["f0", "f1"])


_SYNTHETIC = {
    "node_phase": lambda: _scalar_csg(lambda s: s.add_node(0.25, ["f0"])),
    "pi_product": lambda: _scalar_csg(
        lambda s: s.add_pi_pair(frozenset({"f0"}), frozenset({"f1"}))
    ),
    "phase_pair": lambda: _scalar_csg(lambda s: s.add_phase_pair(1, 7, ["f0"], ["f1"])),
    "halfpi": lambda: _scalar_csg(lambda s: s.add_halfpi(1, ["f0"])),
    "mixed": lambda: _scalar_csg(_mixed),
    "graphs9": lambda: _multi_graph(9),
    "graphs17": lambda: _multi_graph(17),
    "graphs40": lambda: _multi_graph(40),
    "bias_negative": lambda: _bias_graphs(0),
    "bias_positive": lambda: _bias_graphs(150),
}

_CIRCUITS = [
    "H 0\nT 0\nX_ERROR(0.2) 0\nH 0\nM 0",
    "H 0\nH 1\nT 0\nT 1\nCNOT 0 1\nDEPOLARIZE1(0.3) 0 1\n"
    "H 1\nM 0 1\nDETECTOR rec[-1] rec[-2]",
    "H 0\nH 1\nCZ 0 1\nT 0\nX_ERROR(0.25) 1\nH 0 1\nM 0 1",
    "H 0\nS 0\nT 0\nCX 0 1\nT 1\nY_ERROR(0.1) 0\nH 0\nM 0 1",
]


def _circuit_rungs(text):
    sampler = tsim_tpu.Circuit(text).compile_sampler(seed=0)
    return [c for comp in sampler._program.components for c in comp.compiled_scalar_graphs]


def _rows(n_params, batch, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2, size=(batch, n_params)).astype(np.uint8)


def _port_eval(csg, vals):
    tables = SampleTables(rung_from_reference(csg))
    return sample_eval.evaluate_abs_sample(tables, torch.from_numpy(vals)).numpy()


def _check_against_reference(csg, batch=9, seed=42):
    vals = _rows(csg.n_params, batch, seed)
    got = _port_eval(csg, vals)
    np.testing.assert_allclose(got, np.asarray(evaluate_abs(csg, vals)), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(
        got, np.asarray(pallas_sample.evaluate_abs_sample_f32(csg, vals)), rtol=1e-5, atol=1e-7
    )
    assert sample_tables.sample_eligible(csg) == pallas_sample.sample_eligible(csg)
    assert sample_tables._sample_bias(csg) == pallas_sample._sample_bias(csg)


@pytest.mark.parametrize("case", sorted(_SYNTHETIC))
def test_synthetic_rungs_match_tsim_tpu(case):
    _check_against_reference(_SYNTHETIC[case]())


@pytest.mark.parametrize("text", _CIRCUITS)
def test_circuit_rungs_match_tsim_tpu(text):
    for csg in _circuit_rungs(text):
        _check_against_reference(csg)


@pytest.fixture(scope="module")
def d3_rungs():
    """tsim_tpu's d3 distillation rungs (the committed program equals them,
    see test_torch_program_io.py)."""
    program = compile_d3()._program
    return [c for comp in program.components for c in comp.compiled_scalar_graphs]


def test_d3_rungs_match_exact(d3_rungs):
    """All six rungs of d3 distillation, 512 rows each, against tsim_tpu's
    exact evaluator."""
    assert [c.num_graphs for c in d3_rungs] == [1, 5, 6, 103, 60, 103]
    rng = np.random.default_rng(11)
    for csg in d3_rungs:
        assert sample_tables.sample_eligible(csg)
        vals = rng.integers(0, 2, size=(512, csg.n_params)).astype(np.uint8)
        want = np.asarray(evaluate_abs(csg, vals))
        got = _port_eval(csg, vals)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-8)


def test_kernel_configuration_cutoff_matches_tsim_tpu():
    """Rungs below tsim_tpu's transposed-layout cutoff take the small configuration."""
    assert kernel.SMALL_G_CUTOFF == pallas_sample._small_g_cutoff()


def test_ineligible_rung_raises():
    """A rung that fails sample_eligible takes the exact route, as in
    tsim_tpu's evaluate_abs_sample; only f32 tables built for it by hand
    raise."""
    g = ZXGraph()
    g.scalar.add_node(0.25, ["f0"])
    g.scalar.power2 = 230  # sqrt(2)^230 = 2^115: past the f32 budget of sample_eligible, inside the f32 range
    big = compile_scalar_graphs([g], ["f0"])
    assert not sample_tables.sample_eligible(big)
    port = rung_from_reference(big)
    tables = sample_eval.rung_tables(port)
    assert isinstance(tables, ExactTables)
    x = torch.from_numpy(_rows(1, 4, 0))
    got = sample_eval.evaluate_abs_sample(tables, x)
    assert torch.isfinite(got).all() and (got > 2.0**114).all()
    np.testing.assert_array_equal(got.numpy(), evaluate.evaluate_abs(port, x).numpy())
    np.testing.assert_allclose(got.numpy(), np.asarray(evaluate_abs(big, x.numpy())), rtol=5e-6)
    with pytest.raises(ValueError, match="rung_tables"):
        sample_eval.evaluate_abs_sample(SampleTables(port), x)


@pytest.mark.parametrize("evaluation", ["f32", "exact"])
def test_rung_tables_follow_the_mode(d3_rungs, evaluation):
    """f32 mode keeps eligible rungs on the f32 kernel; exact mode sends every
    rung to the exact evaluator (tsim_tpu's TSIM_TPU_SAMPLE_EVAL=exact)."""
    kinds = {type(sample_eval.rung_tables(rung_from_reference(c), evaluation)) for c in d3_rungs}
    assert kinds == {SampleTables if evaluation == "f32" else ExactTables}
    assert sample_eval.norm_deviation_tolerance(evaluation) == (
        3e-3 if evaluation == "f32" else 1e-5
    )
    with pytest.raises(ValueError, match="evaluation"):
        sample_eval.rung_tables(rung_from_reference(d3_rungs[0]), "f64")


def test_zero_graphs_give_zeros():
    g = ZXGraph()
    g.scalar.add_node(0.25, ["f0"])
    g.scalar.is_zero = True
    csg = compile_scalar_graphs([g], ["f0"])
    assert csg.num_graphs == 0
    out = sample_eval.evaluate_abs_sample(
        SampleTables(rung_from_reference(csg)), torch.ones((4, 1), dtype=torch.uint8)
    )
    assert out.dtype == torch.float32 and out.tolist() == [0.0] * 4


@pytest.mark.parametrize("n_params", [0, 5, 32, 33, 100])
def test_pack_words_round_trip(n_params):
    params = _rows(n_params, 24, n_params).reshape(4, 6, n_params)
    w = sample_tables.num_words(n_params)
    words = sample_tables.pack_words(params, w)
    assert words.shape == (4, 6, w) and words.dtype == np.int32
    back = sample_tables.unpack_words(torch.from_numpy(words), n_params)
    np.testing.assert_array_equal(back.numpy(), params)


def test_table_buffer_follows_layout(d3_rungs):
    for csg in d3_rungs:
        tables = SampleTables(csg)
        sizes = [int(np.prod(shape)) for _, shape, _ in tables.layout()]
        assert tables.flat.dtype == torch.int32 and tables.flat.numel() == sum(sizes)
        views = tables.views()
        assert views["pre"].dtype == torch.float32 and views["pre"].shape == (2, csg.num_graphs)


def test_too_many_parameters_raise():
    """Past 128 parameters (four packed words) nothing raises any more: the
    exact tables build and evaluate as tsim_tpu's exact evaluator does, and
    the f32 tables build and evaluate (on the card through the bit-sliced
    small kernel, whose planes are indexed by parameter)."""
    params = [f"f{i}" for i in range(129)]
    csg = _scalar_csg(lambda s: s.add_node(0.25, ["f128"]), params=params)
    port = rung_from_reference(csg)
    vals = _rows(129, 9, 0)
    want = np.asarray(evaluate_abs(csg, vals))
    exact = ExactTables(port)
    assert exact.words == 5
    got = sample_eval.evaluate_abs_sample(exact, torch.from_numpy(vals)).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-6, atol=0)
    tables = SampleTables(port)
    assert tables.words == 5 and kernel.configuration(tables.num_graphs) == "small"
    got = sample_eval.evaluate_abs_sample(tables, torch.from_numpy(vals)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
