"""The CUDA kernels' wrappers, and each kernel against its plain version:
the f32 sampling kernels (``sample_eval.cu``: bit-sliced K1 in both its
instances and K2, per-term K3a/K3b, the self-test K4 and the stage ablation
K8) and the exact kernels (``exact_eval.cu``, K6's stage split included).

This file imports no JAX, so the card's tests run on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Tests marked ``cuda`` skip where no CUDA device is present.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tsim_tpu_torch.compile.evaluate import evaluate_abs, exact_sum
from tsim_tpu_torch.compile.exact_eval import evaluate_abs_exact
from tsim_tpu_torch.compile.exact_tables import ExactTables
from tsim_tpu_torch.compile import node_fold, sample_eval
from tsim_tpu_torch.compile.sample_eval import evaluate_abs_sample, sample_product_sum_reference, synthetic_rung
from tsim_tpu_torch.compile.sample_tables import SampleTables
from tsim_tpu_torch.kernels import build
from tsim_tpu_torch.kernels import exact_eval as exact_kernel
from tsim_tpu_torch.kernels import sample_eval as kernel
from tsim_tpu_torch.models.exported import cultivation_d3, distillation_d3

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-8  # relative to the row's magnitude; f32 summation order differs


@pytest.fixture(scope="module")
def d3_rungs():
    program = distillation_d3(p=0.05).load().program
    return program.components[0].compiled_scalar_graphs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rows(n_params, batch, seed, device="cpu"):
    x = np.random.default_rng(seed).integers(0, 2, size=(batch, n_params)).astype(np.uint8)
    return torch.from_numpy(x).to(device)


def _wide_count(batch: int) -> str:
    """The launch count of the instance of "wide" that ``batch`` rows take."""
    return "wide_32" if kernel.wide_block_shots(batch) == 32 else "wide"


def test_d3_rung_configurations(d3_rungs):
    """The first three d3 rungs take the small configuration, the rest the wide one."""
    assert [kernel.configuration(c.num_graphs) for c in d3_rungs] == ["small"] * 3 + ["wide"] * 3


def test_wrapper_refuses_cpu_tensors(d3_rungs):
    tables = SampleTables(d3_rungs[3])
    with pytest.raises(ValueError, match="CUDA"):
        kernel.sample_product_sum(tables, torch.zeros((2, tables.n_params), dtype=torch.uint8))


def test_cpu_dispatch_takes_plain_version(d3_rungs):
    """CPU rows are evaluated without touching the kernel (its counts stay 0)."""
    kernel.reset_launch_counts()
    for csg in d3_rungs:
        tables = SampleTables(csg)
        mag = evaluate_abs_sample(tables, _rows(tables.n_params, 33, 1))
        assert mag.shape == (33,) and mag.dtype == torch.float32 and mag.device.type == "cpu"
        assert torch.isfinite(mag).all()
    assert kernel.launch_counts == dict.fromkeys(kernel.launch_counts, 0)


def test_build_is_keyed_by_sources():
    lib = build.library_path()
    assert lib.parent.parent == build.BUILD_ROOT
    assert [p.name for p in build.sources()] == ["exact_eval.cu", "noise_draw.cu", "sample_eval.cu"]
    assert lib.parent.name == build._digest()


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 7, 4097])
def test_kernel_matches_plain_version(d3_rungs, cuda, batch):
    kernel.reset_launch_counts()
    for i, csg in enumerate(d3_rungs):
        tables = SampleTables(csg).to(cuda)
        x = _rows(tables.n_params, batch, seed=i, device=cuda)
        got = kernel.sample_product_sum(tables, x)
        want = sample_product_sum_reference(tables, x)
        torch.cuda.synchronize()
        scale = want.norm(dim=1, keepdim=True)
        assert ((got - want).abs() <= ATOL + RTOL * scale).all(), (i, batch)
    assert (kernel.launch_counts[_wide_count(batch)], kernel.launch_counts["small"]) == (3, 3)


def _f32_rungs():
    """(name, rung) for every rung of d3 distillation and of 1- and 2-check
    cultivation, and two seeded rungs over 160 parameters (five words)."""
    out = []
    for label, exported in (
        ("d3", distillation_d3(p=0.05).load()),
        ("cultivation1", cultivation_d3(p=0.001, checks=1).load()),
        ("cultivation", cultivation_d3(p=0.001, checks=2).load()),
    ):
        for comp in exported.program.components:
            out += [(f"{label}[{i}]", c) for i, c in enumerate(comp.compiled_scalar_graphs)]
    out += [(f"seeded G={g} P=160", synthetic_rung(s, g, 160, (6, 4, 4, 2))) for s, g in ((11, 40), (12, 8))]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 7, 4097])
def test_per_term_kernels_match_plain_version(cuda, batch):
    """K3a/K3b and the bit-sliced K1/K2 on every rung, rows of five packed
    words included, against the plain version, within rtol 1e-5 of the row's
    mass (sum over graphs of |product|): cultivation's graph sums cancel to
    near zero on most rows, so f32 rounding is only small against the mass."""
    kernel.reset_launch_counts()
    for i, (name, csg) in enumerate(_f32_rungs()):
        tables = SampleTables(csg).to(cuda)
        x = _rows(tables.n_params, batch, seed=i, device=cuda)
        want, mass = sample_product_sum_reference(tables, x, with_mass=True)
        scale = mass[:, None]
        layout = kernel.layout(tables.num_graphs)
        for config in (f"per_term_{layout}", layout):
            got = kernel.launch(tables, x, config)
            torch.cuda.synchronize()
            assert ((got - want).abs() <= ATOL + RTOL * scale).all(), (name, config, batch)
    launched = ("small", "per_term_small", "per_term_wide", _wide_count(batch))
    assert min(kernel.launch_counts[c] for c in launched) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 31, 4097])
def test_wide_kernel_equals_per_term_wide(cuda, batch):
    """The bit-sliced K1 and the popcount K3a apply the same f32 factors in
    the same order and sum graphs in the same order: equal bit for bit on
    every wide rung, the seeded one over 160 parameters included."""
    for i, (name, csg) in enumerate(_f32_rungs()):
        if kernel.layout(csg.num_graphs) != "wide":
            continue
        tables = SampleTables(csg).to(cuda)
        x = _rows(tables.n_params, batch, seed=i, device=cuda)
        assert torch.equal(kernel.launch(tables, x, "wide"), kernel.launch(tables, x, "per_term_wide")), name


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 31, 33, 1024])
def test_wide_instances_are_bit_equal(cuda, batch):
    """The 32-shot and the 128-shot block of "wide" add each shot's graphs in
    the same order: equal bit for bit on every wide rung of d3 and 1- and
    2-check cultivation, on the seeded one over 160 parameters and on a
    seeded one of 600 graphs (past the 32-shot block's 512 threads, so its
    integer stage takes two chunks), and the row count's own choice is one
    of them."""
    kernel.reset_launch_counts()
    seen = 0
    rungs = _f32_rungs() + [("seeded G=600 P=40", synthetic_rung(13, 600, 40, (6, 4, 4, 2)))]
    for i, (name, csg) in enumerate(rungs):
        if kernel.layout(csg.num_graphs) != "wide":
            continue
        tables = SampleTables(csg).to(cuda)
        x = _rows(tables.n_params, batch, seed=i, device=cuda)
        small = kernel.launch(tables, x, "wide", _block_shots=32)
        large = kernel.launch(tables, x, "wide", _block_shots=128)
        assert torch.equal(small, large), name
        assert torch.equal(kernel.launch(tables, x, "wide"), small), name
        want, mass = sample_product_sum_reference(tables, x, with_mass=True)
        assert ((small - want).abs() <= ATOL + RTOL * mass[:, None]).all(), name
        seen += 1
    assert seen == 3 + 1 + 8 + 1 + 1
    assert kernel.launch_counts["wide_32"] == 2 * seen and kernel.launch_counts["wide"] == seen


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 31, 129, 4097])
def test_small_kernel_equals_per_term_small(cuda, batch):
    """The bit-sliced K2 and the popcount K3b walk the graphs in the same
    order through the same f32 factor code: equal bit for bit on every small
    rung, the term-free 1-graph rungs and the seeded one over 160 parameters
    included, whole blocks of 128 shots and ragged ones."""
    seen = 0
    for i, (name, csg) in enumerate(_f32_rungs()):
        if kernel.layout(csg.num_graphs) != "small":
            continue
        tables = SampleTables(csg).to(cuda)
        x = _rows(tables.n_params, batch, seed=i, device=cuda)
        assert torch.equal(kernel.launch(tables, x, "small"), kernel.launch(tables, x, "per_term_small")), name
        seen += 1
    assert seen == 3 + 8 + 2 + 1


@pytest.mark.cuda
def test_small_kernel_takes_rows_of_two_byte_indices(cuda):
    """From 256 parameters on a list index takes two bytes."""
    tables = SampleTables(synthetic_rung(5, 8, 300, (6, 4, 4, 2))).to(cuda)
    x = _rows(300, 257, seed=5, device=cuda)
    got = kernel.launch(tables, x, "small")
    want, mass = sample_product_sum_reference(tables, x, with_mass=True)
    assert ((got - want).abs() <= ATOL + RTOL * mass[:, None]).all()
    assert torch.equal(got, kernel.launch(tables, x, "per_term_small"))


@pytest.mark.parametrize(
    "rows,words,groups",
    [(1, 1, 1), (31, 2, 1), (16383, 4, 1), (16384, 4, 4), (2**20, 1, 4), (1, 5, 4), (4097, 7, 4)],
)
def test_per_term_wide_instance_by_rows_and_words(rows, words, groups):
    """K3a takes its 32-shot block below WIDE_SMALL_ROWS rows, as "wide"
    does, on rows it holds in registers (up to four packed words)."""
    assert kernel.per_term_wide_groups(rows, words) == groups


def test_plain_version_of_the_32_shot_per_term_instance_is_wides(d3_rungs):
    """On the CPU a per-term rung of fewer than WIDE_SMALL_ROWS rows (K3a's
    32-shot instance on a card) runs the plain version, equal to the wide
    plain reference bit for bit, and launches nothing."""
    kernel.reset_launch_counts()
    for i, csg in enumerate(d3_rungs):
        x = _rows(csg.n_params, 4097, seed=i)
        per_term, packed = SampleTables(csg, per_term=True), SampleTables(csg, per_term=False)
        assert kernel.configuration(csg.num_graphs, per_term=True).startswith("per_term_")
        assert torch.equal(evaluate_abs_sample(per_term, x), evaluate_abs_sample(packed, x))
        assert torch.equal(sample_product_sum_reference(per_term, x), sample_product_sum_reference(packed, x))
    assert kernel.launch_counts == dict.fromkeys(kernel.launch_counts, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_params", [8, 42, 64, 65, 130, 200])
@pytest.mark.parametrize("batch", [1, 31, 32, 33, 4097, 2**16 + 1])
def test_per_term_kernels_equal_packed_ones(cuda, n_params, batch):
    """K3a and K3b against "wide" and "small" bit for bit on seeded rungs of
    40 and 6 graphs: rows in one or two 64-bit registers (8 to 65
    parameters) and through shared memory (130, 200), K3a's 32-shot block
    (below WIDE_SMALL_ROWS rows) and its 128-shot one."""
    kernel.reset_launch_counts()
    for g, config in ((40, "wide"), (6, "small")):
        tables = SampleTables(synthetic_rung(n_params + g, g, n_params, (6, 4, 4, 2))).to(cuda)
        x = _rows(n_params, batch, seed=n_params * g, device=cuda)
        got = kernel.launch(tables, x, f"per_term_{config}")
        assert torch.equal(kernel.launch(tables, x, config), got), (config, n_params, batch)
    short = tables.words <= kernel.PER_TERM_REGISTER_WORDS and batch < kernel.WIDE_SMALL_ROWS
    assert kernel.launch_counts["per_term_wide_32" if short else "per_term_wide"] == 1
    assert kernel.launch_counts["per_term_small"] == 1


@pytest.mark.cuda
def test_self_test_passes_on_the_card(cuda):
    sample_eval.reset_self_test()
    kernel.reset_launch_counts()
    errors = sample_eval.self_test(cuda)
    assert set(errors) == set(kernel.CONFIGURATIONS) and max(errors.values()) <= 1e-5
    assert kernel.launch_counts["self_test"] == 4
    tables = SampleTables(_f32_rungs()[3][1]).to(cuda)
    sample_eval.evaluate_abs_sample_f32(tables, _rows(tables.n_params, 5, 0, cuda))
    assert kernel.launch_counts["self_test"] == 8  # the first launch on the device ran it again


@pytest.mark.cuda
def test_ablation_oracles(cuda):
    """K8 on the 307-graph cultivation rung: "full" is K1 bit for bit, the
    variants with whole families equal the plain version on tables whose
    other families are emptied, the rest are finite."""
    from dev.torch_kernel_ablate import ablate_rung

    circuit = cultivation_d3(p=0.001, checks=2).load().program.components[0].compiled_scalar_graphs[-1]
    kernel.reset_launch_counts()
    results = ablate_rung(circuit, _rows(circuit.n_params, 4097, 3, cuda), reps=1)
    assert [r["name"] for r in results] == [n for n, _, _ in kernel.ABLATION_VARIANTS]
    assert all(r["ok"] for r in results), results
    assert next(r for r in results if r["name"] == "full")["err"] == 0.0
    assert kernel.launch_counts["ablate"] == 6 * 3  # check, warm-up and one timed call each


def _exact_rungs():
    """(name, rung) for every rung of the three committed programs."""
    out = []
    for label, exported in (
        ("d3", distillation_d3(p=0.05).load()),
        ("d3_state_probs", distillation_d3(p=0.05).load_state_probs()),
        ("cultivation", cultivation_d3(p=0.001, checks=2).load()),
    ):
        for comp in exported.program.components:
            out += [(f"{label}[{i}]", c) for i, c in enumerate(comp.compiled_scalar_graphs)]
    return out


@pytest.fixture(scope="module")
def exact_rungs():
    return _exact_rungs()


def test_exact_rungs_reach_all_four_kernels(exact_rungs):
    """The committed programs reach every exact kernel: K5 and K7a on the
    dyadic rungs, K6 and K7b on the approximate ones."""
    reached = {
        f"{'approx' if ExactTables(c).approximate else 'exact'}_"
        f"{exact_kernel.configuration(c.num_graphs)}"
        for _, c in exact_rungs
    }
    assert reached == set(exact_kernel.KERNELS)


def test_exact_wrappers_refuse_cpu_tensors(exact_rungs):
    tables = ExactTables(exact_rungs[-1][1])
    x = torch.zeros((2, tables.n_params), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        exact_kernel.exact_partials(tables, x)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 7, 4097])
def test_exact_kernels_match_plain_version(exact_rungs, cuda, batch):
    """Every rung of the committed programs: exact kernels (K5, K7a) give the
    plain version's magnitudes bit for bit (an exact sum in Z[w] is the same
    in any order); approximate ones (K6, K7b) agree within rtol 1e-5 of the
    row's magnitude (f32 summation order differs)."""
    exact_kernel.reset_launch_counts()
    for i, (name, csg) in enumerate(exact_rungs):
        tables = ExactTables(csg).to(cuda)
        x = _rows(tables.n_params, batch, seed=i, device=cuda)
        got = evaluate_abs_exact(tables, x)
        want = evaluate_abs(tables.circuit(), x)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all(), name
        if tables.approximate:
            assert ((got - want).abs() <= ATOL + RTOL * want).all(), (name, batch)
        else:
            assert torch.equal(got, want), (name, batch)
    assert min(exact_kernel.launch_counts[k] for k in exact_kernel.KERNELS) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 33, 4097])
@pytest.mark.parametrize("n_params", [130, 200])
def test_exact_kernels_take_rows_over_128_parameters(cuda, n_params, batch):
    """Seeded rungs of all four families past four packed words: the wide
    kernels (40 graphs) through the bit-sliced front end, the small ones (5
    graphs) through the small front end; exact bit for bit, approximate
    within rtol 1e-5 of the batch's largest magnitude."""
    exact_kernel.reset_launch_counts()
    for graphs in (5, 40):
        exact = synthetic_rung(n_params + graphs, graphs, n_params, (6, 4, 4, 2))
        factors = np.random.default_rng(graphs).normal(size=(graphs, 2)).astype(np.float32)
        approx = dataclasses.replace(exact, prefactor=dataclasses.replace(
            exact.prefactor, approximate_floatfactors=factors, has_approximate_floatfactors=True))
        for rung in (exact, approx):
            tables = ExactTables(rung).to(cuda)
            assert tables.words > 4
            x = _rows(n_params, batch, seed=graphs, device=cuda)
            got = evaluate_abs_exact(tables, x)
            want = evaluate_abs(tables.circuit(), x)
            torch.cuda.synchronize()
            if tables.approximate:  # random graph sums cancel on some rows: scale by the largest
                assert ((got - want).abs() <= ATOL + RTOL * want.max()).all(), (graphs, batch)
            else:
                assert torch.equal(got, want), (graphs, batch)
    assert min(exact_kernel.launch_counts[k] for k in exact_kernel.KERNELS) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 129, 4097])
def test_exact_wide_equals_the_plain_reader_of_its_fold(exact_rungs, cuda, batch):
    """K5's int32 partials, coefficients and powers, equal bit for bit those
    of the plain reader of its node-phase fold (compile/node_fold.py: K5's
    arithmetic step for step, the dead slots' reduce steps one by one, the
    sums in the kernel's order) on every wide exact rung of the committed
    programs (1-check cultivation's too) and on seeded rungs of 40 graphs
    over 42 and 300 parameters, on seeded rows (most products vanish, and
    many blocks skip a graph) and on rows that solve the folded terms."""
    rungs = [(n, c) for n, c in exact_rungs if c.num_graphs >= kernel.SMALL_G_CUTOFF]
    checks1 = cultivation_d3(p=0.001, checks=1).load().program.components[0].compiled_scalar_graphs
    rungs += [(f"cultivation1[{i}]", c) for i, c in enumerate(checks1) if c.num_graphs >= kernel.SMALL_G_CUTOFF]
    rungs += [(f"seeded P={p}", synthetic_rung(p, 40, p, (8, 3, 3, 2))) for p in (42, 300)]
    exact_kernel.reset_launch_counts()
    seen = 0
    for i, (name, csg) in enumerate(rungs):
        tables = ExactTables(csg).to(cuda)
        if tables.approximate:
            continue
        for rows in (_rows(tables.n_params, batch, seed=i), node_fold.standing_rows(tables, batch, i)):
            out_c, out_p = exact_kernel.exact_partials(tables, rows.to(cuda))
            want_c, want_p = node_fold.kernel_partials(tables, rows, exact_kernel.graph_tile(csg.num_graphs))
            assert torch.equal(out_c.cpu(), want_c) and torch.equal(out_p.cpu(), want_p), (name, batch)
        seen += 1
    assert seen == 8 + 1 + 2
    assert exact_kernel.launch_counts["exact_wide"] == 2 * seen


def _canonical(coeffs: torch.Tensor, power: torch.Tensor):
    """(4, B) coefficients and (B,) power of exact values, with the common
    powers of two taken out of the coefficients (a zero value has power 0):
    two representations of one value become equal."""
    c, p = coeffs.to(torch.int64).clone(), power.to(torch.int64).clone()
    zero = (c == 0).all(dim=0)
    p[zero] = 0
    while True:
        even = ((c & 1) == 0).all(dim=0) & ~zero
        if not even.any():
            return c, p
        c[:, even] >>= 1
        p[even] += 1


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 31, 129, 4097])
def test_exact_small_equals_plain_exact_evaluator(exact_rungs, cuda, batch):
    """K7a, whose parities come from the small front end it shares with K2:
    its exact sums equal the plain exact evaluator's integer for integer and
    its magnitudes bit for bit, on every exact rung under 24 graphs of the
    committed programs (1-check cultivation's too) and on seeded rungs of all
    four families over 130, 200 and 300 parameters (two-byte list indices),
    whole and ragged blocks."""
    rungs = [(n, c) for n, c in exact_rungs if c.num_graphs < kernel.SMALL_G_CUTOFF]
    checks1 = cultivation_d3(p=0.001, checks=1).load().program.components[0].compiled_scalar_graphs
    rungs += [(f"cultivation1[{i}]", c) for i, c in enumerate(checks1) if c.num_graphs < kernel.SMALL_G_CUTOFF]
    rungs += [(f"seeded P={p}", synthetic_rung(p + 5, 5, p, (6, 4, 4, 2))) for p in (130, 200, 300)]
    exact_kernel.reset_launch_counts()
    seen = 0
    for i, (name, csg) in enumerate(rungs):
        tables = ExactTables(csg).to(cuda)
        if tables.approximate:
            continue
        x = _rows(tables.n_params, batch, seed=i, device=cuda)
        out_c, out_p = exact_kernel.exact_partials(tables, x)
        assert out_c.shape == (1, batch, 4)
        want = exact_sum(tables.circuit(), x)
        got_c, got_p = _canonical(out_c[0].T, out_p[0])
        want_c, want_p = _canonical(want.coeffs, want.power)
        assert torch.equal(got_c, want_c) and torch.equal(got_p, want_p), (name, batch)
        assert torch.equal(evaluate_abs_exact(tables, x), evaluate_abs(tables.circuit(), x)), (name, batch)
        seen += 1
    assert seen == 4 + 8 + 3
    assert exact_kernel.launch_counts["exact_small"] == 2 * seen


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 33, 129, 16384])
def test_approx_small_matches_plain_approximate_evaluator(exact_rungs, cuda, batch):
    """K7b, on the small front end it shares with K2 and K7a, against the
    plain approximate evaluator within rtol 1e-5: of the row's magnitude on
    every approximate rung under 24 graphs of the committed programs; of the
    batch's largest magnitude on seeded rungs of all four families over 130,
    200 and 300 parameters (two-byte list indices), whose random graph sums
    cancel on some rows, as in the test above; whole and ragged blocks."""
    rungs = [(n, c) for n, c in exact_rungs if c.num_graphs < kernel.SMALL_G_CUTOFF]
    for p in (130, 200, 300):
        rung = synthetic_rung(p + 7, 5, p, (6, 4, 4, 2))
        factors = np.random.default_rng(p).normal(size=(5, 2)).astype(np.float32)
        rungs.append((f"seeded P={p}", dataclasses.replace(rung, prefactor=dataclasses.replace(
            rung.prefactor, approximate_floatfactors=factors, has_approximate_floatfactors=True))))
    exact_kernel.reset_launch_counts()
    seen = 0
    for i, (name, csg) in enumerate(rungs):
        tables = ExactTables(csg).to(cuda)
        if not tables.approximate:
            continue
        x = _rows(tables.n_params, batch, seed=i, device=cuda)
        assert exact_kernel.approx_partials(tables, x).shape == (1, batch, 2)
        got = evaluate_abs_exact(tables, x)
        want = evaluate_abs(tables.circuit(), x)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all(), (name, batch)
        scale = want.max() if name.startswith("seeded") else want
        assert ((got - want).abs() <= ATOL + RTOL * scale).all(), (name, batch)
        seen += 1
    assert seen == 2 + 3
    assert exact_kernel.launch_counts["approx_small"] == 2 * seen


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 129, 4097])
def test_approximate_kernels_match_plain_version_on_sparse_rows(exact_rungs, cuda, batch):
    """On uniform rows almost every product of the 172-graph rung vanishes;
    on sparse rows (a bit in twenty set, as the noise is) few do. Both within
    rtol 1e-5 of the row's magnitude of the plain exact evaluator."""
    seen = 0
    for i, (name, csg) in enumerate(exact_rungs):
        tables = ExactTables(csg).to(cuda)
        if not tables.approximate:
            continue
        sparse = np.random.default_rng(i).random((batch, tables.n_params)) < 0.05
        x = torch.from_numpy(sparse.astype(np.uint8)).to(cuda)
        got = evaluate_abs_exact(tables, x)
        want = evaluate_abs(tables.circuit(), x)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all() and ((got - want).abs() <= ATOL + RTOL * want).all(), (name, batch)
        seen += 1
    assert seen == 6


@pytest.mark.cuda
def test_approx_ablation_oracles(exact_rungs, cuda):
    """K6's stage split on the 172-graph state-probability rung: "full" is K6
    bit for bit, the emptied variants are finite."""
    from dev.torch_kernel_ablate import ablate_approx_rung

    circuit = dict(exact_rungs)["d3_state_probs[1]"]
    exact_kernel.reset_launch_counts()
    results = ablate_approx_rung(circuit, _rows(circuit.n_params, 4097, 3, cuda), reps=1)
    assert [r["name"] for r in results] == list(exact_kernel.APPROX_ABLATION_VARIANTS)
    assert all(r["ok"] for r in results), results
    assert results[-1]["err"] == 0.0
    assert exact_kernel.launch_counts["approx_ablate"] == 3 * 3  # check, warm-up and one timed call each
    with pytest.raises(ValueError, match="wide"):
        exact_kernel.ablate_approx(ExactTables(dict(exact_rungs)["d3[2]"]).to(cuda), _rows(8, 4, 0, cuda), "full")


@pytest.mark.cuda
def test_exact_kernels_reject_mismatched_inputs(exact_rungs, cuda):
    tables = ExactTables(exact_rungs[-1][1]).to(cuda)
    with pytest.raises(ValueError):
        exact_kernel.exact_partials(
            tables, torch.zeros((4, tables.n_params + 1), dtype=torch.uint8, device=cuda)
        )
    with pytest.raises(ValueError, match="approximate"):
        exact_kernel.approx_partials(
            tables, torch.zeros((4, tables.n_params), dtype=torch.uint8, device=cuda)
        )


@pytest.mark.cuda
def test_kernel_rejects_mismatched_inputs(d3_rungs, cuda):
    tables = SampleTables(d3_rungs[3]).to(cuda)
    with pytest.raises(ValueError):
        kernel.sample_product_sum(tables, torch.zeros((4, tables.n_params + 1), dtype=torch.uint8, device=cuda))
    with pytest.raises(ValueError):
        kernel.sample_product_sum(SampleTables(d3_rungs[3]), torch.zeros((4, tables.n_params), dtype=torch.uint8, device=cuda))


def test_chip_smoke_refuses_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py would run in full")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and "FAIL" in proc.stdout


def _noise_models():
    from tsim_tpu_torch.models.exported import SURFACE_D7_PROGRAM, distillation_d5
    from tsim_tpu_torch.program_io import load_npz

    return {
        "d3": lambda: distillation_d3(p=0.05).load().noise,
        "checks2": lambda: cultivation_d3(p=0.001, checks=2).load().noise,
        "d5": lambda: distillation_d5(p=0.02).load().noise,
        "d7": lambda: load_npz(SURFACE_D7_PROGRAM).noise,
    }


@pytest.mark.cuda
@pytest.mark.parametrize("program", ["d3", "checks2", "d5", "d7"])
@pytest.mark.parametrize("rows", [1, 127, 4097, 1 << 17])
def test_noise_draw_kernel_equals_plain_version(cuda, program, rows):
    """The noise-draw kernel against the plain draw on the same seeded
    uniforms, bit for bit: packed (d3), bitplanes (2-check, d5) and the
    d7 surface code's W = 11 words through L1/L2."""
    from tsim_tpu_torch.kernels import noise_draw
    from tsim_tpu_torch.noise.device_channels import DeviceChannelSampler

    sampler = DeviceChannelSampler(_noise_models()[program](), cuda)
    g = torch.Generator(device=cuda).manual_seed(rows)
    u = torch.rand((rows, sampler.num_channels), generator=g, device=cuda)
    before = noise_draw.launch_counts["noise_draw"]
    got = sampler.from_uniforms(u)
    want = sampler.sample_from_uniforms(u)
    torch.cuda.synchronize()
    assert noise_draw.launch_counts["noise_draw"] == before + 1
    assert got.dtype == torch.uint8 and got.shape == (rows, sampler.num_f)
    assert torch.equal(got, want)
