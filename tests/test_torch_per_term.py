"""The per-term f32 configurations (K3a, K3b), their dispatch, and the
start-up self-test of the f32 kernels (K4), on the CPU.

tsim_tpu runs its per-term kernels ``_kernel_sample_unpacked`` (K3a) and
``_kernel_sample_t_unpacked`` (K3b) in interpret mode when
``TSIM_TPU_SAMPLE_TPACK=0``; the port's plain f32 version must agree with
them within the tolerance ``test_torch_sample_eval.py`` holds it to against
tsim_tpu's f32 kernels (rtol 1e-5, atol 1e-7: only the f32 summation order
differs), on the synthetic rungs of that file, every rung of d3
distillation and of 1-check cultivation, and a synthetic rung over 160
parameters (five packed words, past the packed kernels' four). The
64-graph rung of 1-check cultivation (T = 19, 15, 14, 1 terms) is the
exception: XLA's CPU compile of its interpret-mode kernel did not finish in
15 minutes, so K3a's body (``_product_body_sample``) runs op by op on
tsim_tpu's own tables, one graph tile at a time. The CUDA kernels
themselves are held against the plain version on the card
(``tests/test_torch_kernels.py``, ``chip_smoke.py``).
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsim_tpu.compile import pallas_sample
from tsim_tpu.compile.compile import compile_scalar_graphs
from tsim_tpu.zx.graph import ZXGraph
from dev.export_torch_program import compile_cultivation, compile_d3
from tests.test_torch_sample_eval import _SYNTHETIC
from tsim_tpu_torch.compile import sample_eval
from tsim_tpu_torch.compile.exact_tables import ExactTables
from tsim_tpu_torch.compile.sample_tables import SampleTables
from tsim_tpu_torch.kernels import exact_eval as exact_kernel
from tsim_tpu_torch.kernels import sample_eval as kernel
from tsim_tpu_torch.program_io import rung_from_reference

RTOL, ATOL = 1e-5, 1e-7
WIDE_PARAMS = 160
EAGER_CASES = {"cult1[8]"}  # interpret-mode compile too slow on a CPU (see above)


def _wide_params_rung():
    """30 graphs (the wide layout) whose terms reach parameters 0 to 159."""
    params = [f"f{i}" for i in range(WIDE_PARAMS)]
    rng = np.random.default_rng(3)
    graphs = []
    for k in range(30):
        g = ZXGraph()
        for j in range(k % 3 + 1):
            picks = rng.choice(WIDE_PARAMS, size=3, replace=False)
            g.scalar.add_node(Fraction(1, 4) * (2 * j + 1), [params[i] for i in picks])
        a, b = rng.choice(WIDE_PARAMS, size=2, replace=False)
        g.scalar.add_phase_pair(1, 7, [params[a], params[150]], [params[b]])
        g.scalar.add_halfpi(k % 8, [params[159], params[k]])
        g.scalar.add_pi_pair(frozenset({params[100 + k]}), frozenset({params[40 + k]}))
        g.scalar.power2 -= k % 3
        graphs.append(g)
    return compile_scalar_graphs(graphs, params)


def _per_term_wide_eager(csg, vals):
    """|amplitude| per row from K3a's body run op by op, outside pallas_call,
    on the tables and graph tiles tsim_tpu's dispatch prepares for it."""
    P = max(csg.n_params, 8)
    x = np.zeros((len(vals), P), np.uint8)
    x[:, : csg.n_params] = vals
    buckets, bias = pallas_sample._prepared_sample_buckets(csg, P)
    total = np.zeros((len(vals), 2), np.float32)
    for tables, (t1, t2, t3, t4, gt, gp, bt) in buckets:
        assert bt != 0, "wide layout only"
        for j in range(gp // gt):
            tile = [jnp.asarray(tables[k])[:, j * gt : (j + 1) * gt] for k in pallas_sample._TABLE_KEYS]
            re, im = pallas_sample._product_body_sample((t1, t2, t3, t4, gt), False, jnp.asarray(x), *tile)
            total += np.stack([np.asarray(re).sum(axis=1), np.asarray(im).sum(axis=1)], axis=1)
    mag = np.sqrt(total[:, 0] ** 2 + total[:, 1] ** 2)
    h = bias // 2
    return mag * np.float32(2.0**h) * np.float32(2.0 ** (bias - h))


@pytest.fixture(scope="module")
def rungs():
    """tsim_tpu's rungs by case: d3 distillation, 1-check cultivation, P = 160."""
    out = {}
    for label, sampler in (("d3", compile_d3()), ("cult1", compile_cultivation(checks=1))):
        program = sampler._program
        for i, c in enumerate(c for comp in program.components for c in comp.compiled_scalar_graphs):
            out[f"{label}[{i}]"] = c
    out["p160"] = _wide_params_rung()
    return out


_CASES = (
    [f"synthetic:{name}" for name in sorted(_SYNTHETIC)]
    + [f"d3[{i}]" for i in range(6)]
    + [f"cult1[{i}]" for i in range(9)]
    + ["p160"]
)


@pytest.mark.parametrize("case", _CASES)
def test_plain_version_matches_tsim_tpu_per_term_kernels(monkeypatch, rungs, case):
    csg = _SYNTHETIC[case.split(":")[1]]() if case.startswith("synthetic:") else rungs[case]
    monkeypatch.setenv("TSIM_TPU_SAMPLE_TPACK", "0")  # tsim_tpu's side; the port takes an argument
    assert not pallas_sample._use_tpack()
    vals = np.random.default_rng(len(case)).integers(0, 2, size=(64, csg.n_params)).astype(np.uint8)
    if case in EAGER_CASES:
        want = _per_term_wide_eager(csg, vals)
    else:
        want = np.asarray(pallas_sample.evaluate_abs_sample_f32(csg, vals))
    tables = SampleTables(rung_from_reference(csg), per_term=True)
    assert kernel.configuration(tables.num_graphs, tables.per_term) == (
        "per_term_" + kernel.layout(tables.num_graphs)
    )
    assert kernel.layout(tables.num_graphs) == (
        "small" if csg.num_graphs < pallas_sample._small_g_cutoff() else "wide"
    )
    got = sample_eval.evaluate_abs_sample_f32(tables, torch.from_numpy(vals)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_cultivation_checks1_rungs(rungs):
    """1-check cultivation: G = 1 to 64 over P = 20 to 28, every rung f32-eligible."""
    cult1 = [rungs[f"cult1[{i}]"] for i in range(9)]
    assert [c.num_graphs for c in cult1] == [1, 4, 8, 8, 16, 16, 16, 16, 64]
    assert [c.n_params for c in cult1] == list(range(20, 29))
    assert all(pallas_sample.sample_eligible(c) for c in cult1)


def test_wide_rows_take_the_per_term_configuration(rungs):
    """Rows past four packed words take the per-term configuration only where
    the caller asks for it: the bit-sliced kernels index their planes by
    parameter, so the f32 tables build (no cap) and keep "wide" or "small"
    with the packed kernels on; exact tables have no cap either."""
    port = rung_from_reference(rungs["p160"])
    tables = SampleTables(port)
    assert tables.words == 5 and tables.num_graphs == 30
    assert kernel.use_packed()
    assert kernel.configuration(tables.num_graphs) == "wide"
    assert kernel.configuration(tables.num_graphs, per_term=True) == "per_term_wide"
    exact = ExactTables(port)
    assert exact.words == 5 and exact_kernel.configuration(exact.num_graphs) == "wide"


def test_configuration_follows_the_switch(monkeypatch):
    """TSIM_TPU_SAMPLE_TPACK=0 sends every f32 rung to the per-term kernels,
    as tsim_tpu's switch does; the exact kernels' layout does not follow it."""
    graphs = [1, 6, 23, 24, 103, 307]
    monkeypatch.delenv("TSIM_TPU_SAMPLE_TPACK", raising=False)
    packed = [kernel.configuration(g) for g in graphs]
    assert packed == ["small", "small", "small", "wide", "wide", "wide"]
    monkeypatch.setenv("TSIM_TPU_SAMPLE_TPACK", "0")
    assert [kernel.configuration(g) for g in graphs] == [f"per_term_{c}" for c in packed]
    assert [exact_kernel.configuration(g) for g in graphs] == packed
    assert [kernel.configuration(g, per_term=False) for g in graphs] == packed  # the argument wins
    monkeypatch.setenv("TSIM_TPU_SAMPLE_TPACK", "1")
    assert [kernel.configuration(g) for g in graphs] == packed
    assert [kernel.configuration(g, per_term=True) for g in graphs] == [f"per_term_{c}" for c in packed]


def test_launch_refuses_long_rows_on_packed_kernels():
    tables = SampleTables(sample_eval.synthetic_rung(0, 30, WIDE_PARAMS))
    x = torch.zeros((4, WIDE_PARAMS), dtype=torch.uint8)
    for config in ("small", "wide"):  # the bit-sliced kernels take any row: only the device is refused
        with pytest.raises(ValueError, match="CUDA"):
            kernel.launch(tables, x, config)
    with pytest.raises(ValueError, match="configuration"):
        kernel.launch(tables, x, "per_term")
    with pytest.raises(ValueError, match="CUDA"):
        kernel.launch(tables, x, "per_term_wide")


def test_ablation_variants_match_tsim_tpu_tool():
    """The K8 variants carry dev/kernel_ablate.py's names and stage sets."""
    assert [name for name, _, _ in kernel.ABLATION_VARIANTS] == [
        "empty", "par1", "par-all", "par1+T1", "par+T1..T3", "full",
    ]
    for name, parities, factors in kernel.ABLATION_VARIANTS:
        assert set(factors) <= set(parities), name


# ------------------------------------------------------------- K4 self-test
@pytest.fixture
def fresh_self_test():
    sample_eval.reset_self_test()
    kernel.reset_launch_counts()
    yield
    sample_eval.reset_self_test()
    kernel.reset_launch_counts()


def _fake_launch(wrong: str | None = None):
    """A stand-in for the CUDA launch on CPU tensors: the plain version,
    counted as the real launch is, off by 1e-3 for configuration ``wrong``."""

    def launch(tables, x, config, count_as=None):
        out = sample_eval.sample_product_sum_reference(tables, x)
        kernel.launch_counts[count_as or config] += 1
        return out * 1.001 if config == wrong else out

    return launch


def test_probe_inputs_have_the_probe_shape():
    tables, rows = sample_eval.probe_inputs("cpu")
    assert rows.shape == (sample_eval.PROBE_ROWS, sample_eval.PROBE_PARAMS) == (128, 8)
    assert rows.dtype == torch.uint8 and 0 < int(rows.sum()) < rows.numel()
    for name, graphs in (("wide", 128), ("small", 8)):
        t = tables[name]
        assert (t.num_graphs, t.n_params, t.words, t.dims) == (graphs, 8, 1, (2, 2, 2, 2))
        assert kernel.layout(t.num_graphs) == name
        v = t.views()
        for seg in ("np_cos", "hp_coeffs", "pp_psi_c", "qp_ca", "pre"):
            assert v[seg].abs().sum() > 0, (name, seg)  # every family live, unlike the TPU probe
    again, _ = sample_eval.probe_inputs("cpu")
    assert torch.equal(again["wide"].flat, tables["wide"].flat)  # seeded


def test_self_test_passes_and_counts(monkeypatch, fresh_self_test):
    monkeypatch.setattr(kernel, "launch", _fake_launch())
    errors = sample_eval.self_test("cpu")
    assert set(errors) == set(kernel.CONFIGURATIONS) and max(errors.values()) == 0.0
    assert kernel.launch_counts["self_test"] == 4
    assert all(kernel.launch_counts[c] == 0 for c in kernel.CONFIGURATIONS)
    sample_eval.ensure_self_test("cpu")
    sample_eval.ensure_self_test("cpu")  # cached: runs once per device
    assert kernel.launch_counts["self_test"] == 8


@pytest.mark.parametrize("wrong", kernel.CONFIGURATIONS)
def test_self_test_failure_raises_and_switches_nothing(monkeypatch, fresh_self_test, wrong):
    monkeypatch.setattr(kernel, "launch", _fake_launch(wrong))
    with pytest.raises(RuntimeError, match=f"configuration '{wrong}'"):
        sample_eval.ensure_self_test("cpu")
    runs = kernel.launch_counts["self_test"]
    assert runs == kernel.CONFIGURATIONS.index(wrong) + 1  # stops at the failing one
    # The failure is kept: later launches raise again without a new test,
    # and the dispatch still names the same configurations.
    with pytest.raises(RuntimeError, match=f"configuration '{wrong}'"):
        sample_eval.ensure_self_test("cpu")
    assert kernel.launch_counts["self_test"] == runs
    assert kernel.configuration(103) == "wide" and kernel.configuration(6) == "small"
    assert kernel.use_packed()
    assert all(kernel.launch_counts[c] == 0 for c in kernel.CONFIGURATIONS)
