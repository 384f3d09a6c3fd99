"""The port's exact evaluator against tsim_tpu's, on the same rows.

Exact Z[w] values (``ExactScalarArray`` operations, term families, graph
sums) must equal tsim_tpu's integer for integer. Magnitudes of exact rungs
are compared in two ways: bit for bit (atol 0) against tsim_tpu's exact
graph sum converted by the port's float conversion, and within rtol 5e-6
against ``tsim_tpu.compile.evaluate.evaluate_abs`` itself, whose ``2^p``
is XLA's CPU ``exp2`` (off by up to 4e-6 relative on integer arguments,
measured; ``test_xla_exp2_error_is_within_tolerance``), where the port scales exactly.
Rungs with approximate floatfactors sum in f32 in another order: rtol
1e-6. Circuits: the term families of
``tests/unit/compile/test_exact_and_terms.py``, the synthetic rungs of
``test_torch_sample_eval.py`` and small circuits here; every rung of d3
distillation, d3 state probabilities and 2-check cultivation at 256 rows in
``test_torch_exact_workloads.py``. Tables, chunking and the dispatch are
checked on the committed programs.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsim_tpu.compile import evaluate as jax_evaluate
from tsim_tpu.compile import terms as jax_terms
from tsim_tpu.compile.pallas_evaluate import evaluate_abs_fused, evaluate_abs_fused_small
from tsim_tpu.core.exact_scalar import ExactScalarArray as JaxESA
from tsim_tpu.ops.gf2 import matmul_gf2 as jax_matmul_gf2
from tests.test_torch_sample_eval import _CIRCUITS, _SYNTHETIC, _circuit_rungs, _scalar_csg
from tsim_tpu_torch import program_io
from tsim_tpu_torch.compile import evaluate, exact_eval, terms
from tsim_tpu_torch.compile.exact_tables import ExactTables
from tsim_tpu_torch.compile.sample_eval import synthetic_rung
from tsim_tpu_torch.core.exact_scalar import ExactScalarArray, exact_magnitude, exp2_int
from tsim_tpu_torch.kernels import exact_eval as kernel
from tsim_tpu_torch.models.exported import cultivation_d3, distillation_d3
from tsim_tpu_torch.ops.gf2 import matmul_gf2
from tsim_tpu_torch.program_io import rung_from_reference

XLA_EXP2_RTOL = 5e-6
APPROX_RTOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _same_raw(port: ExactScalarArray, ref: JaxESA):
    """Same coefficients and powers, integer for integer."""
    np.testing.assert_array_equal(port.coeffs.numpy(), np.asarray(ref.coeffs))
    np.testing.assert_array_equal(port.power.numpy(), np.asarray(ref.power))


def _canonical(coeffs, power):
    """The reduced form of exact values: common factors of 2 moved into the
    power, zeros at power 0."""
    c = np.array(coeffs, np.int64)
    p = np.array(power, np.int64)
    nonzero = (c != 0).any(axis=0)
    while True:
        even = nonzero & ((c & 1) == 0).all(axis=0)
        if not even.any():
            break
        c[:, even] >>= 1
        p[even] += 1
    p[~nonzero] = 0
    return c, p


def _rows(n_params, batch, seed):
    return np.random.default_rng(seed).integers(0, 2, size=(batch, n_params)).astype(np.uint8)


# ------------------------------------------------------------ exact scalars

def test_omega_tables_match():
    k = np.arange(8)
    np.testing.assert_array_equal(terms.UNIT_PHASES, jax_terms.UNIT_PHASES)
    np.testing.assert_array_equal(
        terms.omega_coeffs(_t(k)).numpy(), np.asarray(jax_terms.omega_coeffs(jnp.asarray(k)))
    )
    np.testing.assert_array_equal(
        terms.one_plus_omega_coeffs(_t(k)).numpy(),
        np.asarray(jax_terms.one_plus_omega_coeffs(jnp.asarray(k))),
    )


def _random_esa(seed, shape, lo=-3, hi=4):
    rng = np.random.default_rng(seed)
    coeffs = rng.integers(lo, hi, size=(4,) + shape).astype(np.int32)
    power = rng.integers(-2, 3, size=shape).astype(np.int32)
    return (
        ExactScalarArray(coeffs=_t(coeffs), power=_t(power)),
        JaxESA(coeffs=jnp.asarray(coeffs), power=jnp.asarray(power)),
    )


@pytest.mark.parametrize("op", ["mul", "sum_last", "sum_first", "prod_last", "prod_first"])
def test_exact_scalar_ops_match(op):
    port, ref = _random_esa(0, (5, 7))
    if op == "mul":
        _same_raw(port * port, ref * ref)
    else:
        name, where = op.split("_")
        axis = -1 if where == "last" else 0
        _same_raw(getattr(port, name)(axis=axis), getattr(ref, name)(axis=axis))


@pytest.mark.parametrize("n", [1, 2, 3, 7, 16, 33])
def test_tree_reductions_match(n):
    """Tree prod over 1 + w^k leaves and tree sum over small values, any n."""
    rng = np.random.default_rng(3)
    ks = rng.integers(0, 8, size=(n, 5))
    leaves = np.asarray(jax_terms.one_plus_omega_coeffs(jnp.asarray(ks)))
    power = rng.integers(-3, 4, size=(n, 5)).astype(np.int32)
    port = ExactScalarArray(coeffs=_t(leaves), power=_t(power))
    ref = JaxESA(coeffs=jnp.asarray(leaves), power=jnp.asarray(power))
    _same_raw(port.prod(axis=0), ref.prod(axis=0))
    port, ref = _random_esa(n, (n, 5), -2, 3)
    _same_raw(port.sum(axis=0), ref.sum(axis=0))


def test_long_sum_and_abs():
    coeffs = np.tile(np.array([0, 1, 0, -1], np.int32)[:, None], (1, 40))
    out = ExactScalarArray.from_coeffs(_t(coeffs)).sum(axis=-1)
    _same_raw(out, JaxESA.from_coeffs(jnp.asarray(coeffs)).sum(axis=-1))
    np.testing.assert_allclose(out.abs().numpy(), 40 * np.sqrt(2), rtol=1e-6)
    port, _ = _random_esa(1, (9,))
    c, p = port.coeffs.numpy().astype(float), port.power.numpy()
    w = np.exp(1j * np.pi / 4)
    want = np.abs((c[0] + c[1] * w + c[2] * 1j + c[3] * w**3) * 2.0**p)
    np.testing.assert_allclose(port.abs().numpy(), want, rtol=1e-6)
    re, im = port.to_real_imag()
    np.testing.assert_allclose(np.hypot(re.numpy(), im.numpy()), want, rtol=1e-6)


def test_exp2_int_is_exact():
    p = np.arange(-160, 140, dtype=np.int32)
    with np.errstate(over="ignore"):
        want = np.exp2(p.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(exp2_int(_t(p)).numpy(), want)


def test_xla_exp2_error_is_within_tolerance():
    """Why magnitudes are held to tsim_tpu's exact sums rather than to its
    evaluate_abs bit for bit: XLA's CPU exp2 misses 2^p for some integers p."""
    p = np.arange(-40, 40, dtype=np.int32)
    got = np.asarray(jnp.exp2(jnp.asarray(p).astype(jnp.float32)))
    want = np.exp2(p.astype(np.float64)).astype(np.float32)
    rel = np.abs(got / want - 1)
    assert rel.max() <= 4e-6 and XLA_EXP2_RTOL > rel.max()


# ------------------------------------------------------------ term families

def test_matmul_gf2_matches():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 2, size=(3, 4, 300)).astype(np.uint8)  # row sums above 255
    b = rng.integers(0, 2, size=(6, 300)).astype(np.uint8)
    got = matmul_gf2(_t(a), _t(b))
    assert got.dtype == torch.uint8 and got.shape == (6, 3, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_matmul_gf2(jnp.asarray(a), jnp.asarray(b))))
    assert matmul_gf2(torch.zeros((0, 4, 3), dtype=torch.uint8), _t(b[:, :3])).shape == (6, 0, 4)


_FAMILIES = {
    "node_phases": (
        "NodePhases", terms.evaluate_node_phases,
        dict(
            phases=np.array([[1, 3, 0], [2, 0, 0]], np.uint8),
            params=np.array([[[1, 0], [0, 1], [0, 0]], [[1, 1], [0, 0], [0, 0]]], np.uint8),
            counts=np.array([2, 1, 0], np.int32),
        ),
    ),
    "halfpi_phases": (
        "HalfPiPhases", terms.evaluate_halfpi_phases,
        dict(
            coeffs=np.array([[2, 6], [4, 0]], np.uint8),
            params=np.array([[[1, 0], [0, 1]], [[1, 1], [0, 0]]], np.uint8),
        ),
    ),
    "pi_products": (
        "PiProducts", terms.evaluate_pi_products,
        dict(
            psi_const=np.array([[1], [0]], np.uint8),
            psi_params=np.array([[[1, 0]], [[0, 1]]], np.uint8),
            phi_const=np.array([[0], [1]], np.uint8),
            phi_params=np.array([[[0, 1]], [[1, 1]]], np.uint8),
        ),
    ),
    "phase_pairs": (
        "PhasePairs", terms.evaluate_phase_pairs,
        dict(
            alpha=np.array([[2], [5]], np.uint8),
            alpha_params=np.array([[[1, 0]], [[0, 0]]], np.uint8),
            beta=np.array([[1], [0]], np.uint8),
            beta_params=np.array([[[0, 1]], [[1, 1]]], np.uint8),
            counts=np.array([2], np.int32),
        ),
    ),
}


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_term_families_match(family):
    cls_name, port_eval, arrays = _FAMILIES[family]
    port_fam = getattr(program_io, cls_name)(**arrays)
    jax_fam = getattr(jax_terms, cls_name)(**{k: jnp.asarray(v) for k, v in arrays.items()})
    bits = np.array(list(itertools.product([0, 1], repeat=2)), np.uint8)
    _same_raw(port_eval(port_fam, _t(bits)), jax_fam.evaluate(jnp.asarray(bits)))


# ------------------------------------------------------- evaluate_abs/evaluate

@jax.jit
def _jax_reference(csg, rows):
    """tsim_tpu's evaluate_abs and, for a rung without approximate
    floatfactors, its exact graph sum (coefficients, power)."""
    mag = jax_evaluate.evaluate_abs(csg, rows)
    if csg.prefactor.phase_indices.shape[0] == 0 or csg.prefactor.has_approximate_floatfactors:
        return mag, None, None
    total = jax_evaluate._evaluate_parts(csg, rows)
    s = JaxESA(coeffs=total.coeffs, power=total.power + csg.prefactor.power2).sum()
    return mag, s.coeffs, s.power


def _check_rung(csg, rows):
    """The port's plain evaluator against tsim_tpu's on one rung."""
    port = rung_from_reference(csg)
    x = _t(rows)
    got = evaluate.evaluate_abs(port, x).numpy()
    want, coeffs, power = (None if a is None else np.asarray(a) for a in _jax_reference(csg, rows))
    assert got.dtype == np.float32 and got.shape == (rows.shape[0],)
    if coeffs is None:
        np.testing.assert_allclose(got, want, rtol=APPROX_RTOL, atol=0)
        return
    mine = evaluate.exact_sum(port, x)
    for a, b in zip(
        _canonical(mine.coeffs.numpy(), mine.power.numpy()), _canonical(coeffs, power)
    ):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got, exact_magnitude(_t(coeffs), _t(power)).numpy())
    np.testing.assert_allclose(got, want, rtol=XLA_EXP2_RTOL, atol=0)


@pytest.mark.parametrize("case", sorted(_SYNTHETIC))
def test_synthetic_rungs_match(case):
    csg = _SYNTHETIC[case]()
    _check_rung(csg, _rows(csg.n_params, 9, 42))


_ROTATION = "H 0 1\nR_Z(0.3) 0\nCNOT 0 1\nX_ERROR(0.1) 1\nH 0\nM 0 1"


@pytest.mark.parametrize("case", ["mixed", "graphs9"])
def test_complex_amplitudes_match(case):
    """``evaluate`` (complex amplitudes), on exact rungs and on a rung with
    approximate floatfactors (an R_Z rotation)."""
    for csg in (_SYNTHETIC[case](), *_circuit_rungs(_ROTATION)[:2]):
        rows = _rows(csg.n_params, 9, 5)
        want = np.asarray(jax.jit(jax_evaluate.evaluate)(csg, jnp.asarray(rows)))
        got = evaluate.evaluate(rung_from_reference(csg), _t(rows)).numpy()
        assert got.dtype == np.complex64
        rtol = APPROX_RTOL if csg.prefactor.has_approximate_floatfactors else XLA_EXP2_RTOL
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-12)


@pytest.mark.parametrize("text", [*_CIRCUITS, _ROTATION])
def test_circuit_rungs_match(text):
    for csg in _circuit_rungs(text):
        _check_rung(csg, _rows(csg.n_params, 16, 7))


@pytest.fixture(scope="module")
def committed_rungs():
    """Every rung of the committed d3, d3 state-probability and cultivation
    programs, as the port's numpy dataclasses (test_torch_program_io.py holds
    each file equal to a fresh export from tsim_tpu)."""
    programs = {
        "d3": distillation_d3(p=0.05).load(),
        "d3_state_probs": distillation_d3(p=0.05).load_state_probs(),
        "cultivation": cultivation_d3(p=0.001, checks=2).load(),
    }
    return {
        name: [c for comp in exported.program.components for c in comp.compiled_scalar_graphs]
        for name, exported in programs.items()
    }


@pytest.mark.parametrize(
    "build",
    [
        lambda s: s.add_node(0.25, ["f0"]),
        lambda s: s.add_pi_pair(frozenset({"f0"}), frozenset({"f1"})),
        lambda s: s.add_phase_pair(1, 7, ["f0"], ["f1"]),
        lambda s: s.add_halfpi(1, ["f0"]),
    ],
    ids=["node_phase", "pi_product", "phase_pair", "halfpi"],
)
def test_single_term_graphs_match_tsim_tpu_kernels(build):
    """tsim_tpu's K5 and K7a in interpret mode, on single-term graphs (beyond
    them interpret mode is very slow on the CPU)."""
    csg = _scalar_csg(build)
    rows = _rows(csg.n_params, 9, 42)
    got = evaluate.evaluate_abs(rung_from_reference(csg), _t(rows)).numpy()
    np.testing.assert_allclose(got, np.asarray(evaluate_abs_fused(csg, rows)), rtol=XLA_EXP2_RTOL, atol=0)
    np.testing.assert_allclose(
        got, np.asarray(evaluate_abs_fused_small(csg, rows)), rtol=XLA_EXP2_RTOL, atol=0
    )


def test_rows_are_evaluated_in_chunks(committed_rungs, monkeypatch):
    csg = committed_rungs["cultivation"][9]
    x = _t(_rows(csg.n_params, 40, 3))
    whole = evaluate.evaluate_abs(csg, x)
    monkeypatch.setattr(evaluate, "CHUNK_BYTES", 1)
    assert evaluate.chunk_rows(csg) == 1
    np.testing.assert_array_equal(evaluate.evaluate_abs(csg, x).numpy(), whole.numpy())


# --------------------------------------------------------------- exact tables

def test_exact_tables_round_trip(committed_rungs):
    """The flat buffer holds every segment of the layout, and the rung read
    back from it evaluates bit for bit as the original."""
    for name in ("d3", "d3_state_probs", "cultivation"):
        for i, csg in enumerate(committed_rungs[name]):
            tables = ExactTables(csg)
            sizes = [int(np.prod(shape)) for _, shape, _ in tables.layout()]
            assert tables.flat.dtype == torch.int32 and tables.flat.numel() == sum(sizes)
            assert tables.approx.shape == (2, csg.num_graphs)
            back = tables.circuit()
            np.testing.assert_array_equal(back.phase_pairs.beta_params.numpy(), csg.phase_pairs.beta_params)
            np.testing.assert_array_equal(back.prefactor.floatfactor.numpy(), csg.prefactor.floatfactor)
            x = _t(_rows(csg.n_params, 32, i))
            np.testing.assert_array_equal(
                evaluate.evaluate_abs(back, x).numpy(), evaluate.evaluate_abs(csg, x).numpy()
            )


@pytest.mark.parametrize("n_graphs", [5, 40])
@pytest.mark.parametrize("n_params", [130, 200])
def test_exact_tables_round_trip_past_four_words(n_params, n_graphs):
    """Rows over 128 parameters: the tables build, hold the packed words and
    the bit lists of the layout, and the rung read back evaluates bit for bit
    as the original (tests/test_torch_bitsliced.py holds such rungs against
    tsim_tpu's evaluate_abs)."""
    csg = synthetic_rung(n_params + n_graphs, n_graphs, n_params, (3, 3, 2, 2))
    tables = ExactTables(csg)
    assert tables.words == -(-n_params // 32) > 4
    sizes = {name: int(np.prod(shape)) for name, shape, _ in tables.layout()}
    assert tables.flat.numel() == sum(sizes.values())
    assert sizes["bs_words"] == (tables.list_words + 4) * n_graphs and tables.list_words > 0
    back = tables.circuit()
    np.testing.assert_array_equal(back.node_phases.params.numpy(), csg.node_phases.params)
    np.testing.assert_array_equal(back.pi_products.phi_params.numpy(), csg.pi_products.phi_params)
    x = _t(_rows(n_params, 33, n_graphs))
    want = evaluate.evaluate_abs(csg, x).numpy()
    np.testing.assert_array_equal(evaluate.evaluate_abs(back, x).numpy(), want)
    np.testing.assert_array_equal(exact_eval.evaluate_abs_exact(tables, x).numpy(), want)


def test_live_lengths_cover_live_terms(committed_rungs):
    for csg in committed_rungs["cultivation"]:
        v = ExactTables(csg).views()
        live = (v["hp_coeffs"] != 0) & (v["hp_words"] != 0).any(dim=2)
        t = torch.arange(live.shape[0])[:, None]
        assert not (live & (t >= v["hp_len"][None])).any()
        assert (v["pp_len"] <= v["pp_psi_c"].shape[0]).all()


# ------------------------------------------------------------------ dispatch

def _graph_slice(csg, idx):
    """The graphs ``idx`` of a numpy rung, as a rung of their own."""
    def fam(obj, cls):
        kw = {}
        for f in dataclasses.fields(cls):
            a = np.asarray(getattr(obj, f.name))
            kw[f.name] = a[idx] if a.ndim == 1 else a[:, idx]
        return cls(**kw)

    pf = csg.prefactor
    return program_io.CompiledScalarGraphs(
        num_graphs=len(idx), n_params=csg.n_params,
        node_phases=fam(csg.node_phases, program_io.NodePhases),
        halfpi_phases=fam(csg.halfpi_phases, program_io.HalfPiPhases),
        pi_products=fam(csg.pi_products, program_io.PiProducts),
        phase_pairs=fam(csg.phase_pairs, program_io.PhasePairs),
        prefactor=program_io.ScalarPrefactor(
            phase_indices=pf.phase_indices[idx], floatfactor=pf.floatfactor[idx],
            power2=pf.power2[idx], approximate_floatfactors=pf.approximate_floatfactors[idx],
            has_approximate_floatfactors=pf.has_approximate_floatfactors,
        ),
    )


def test_combine_partials_equals_whole_sum(committed_rungs):
    """Per-tile exact partials (as the wide kernel writes them) combine to the
    magnitude of the whole graph sum, bit for bit."""
    csg = committed_rungs["cultivation"][9]
    x = _t(_rows(csg.n_params, 64, 9))
    tile = kernel.graph_tile(csg.num_graphs)
    assert kernel.num_tiles(csg.num_graphs) == 3 and tile == 128
    parts = [
        evaluate.exact_sum(_graph_slice(csg, np.arange(s, min(s + tile, csg.num_graphs))), x)
        for s in range(0, csg.num_graphs, tile)
    ]
    out_c = torch.stack([p.coeffs.T for p in parts])  # (n_tiles, B, 4)
    out_p = torch.stack([p.power for p in parts])
    np.testing.assert_array_equal(
        exact_eval.combine_partials(out_c, out_p).numpy(), evaluate.evaluate_abs(csg, x).numpy()
    )


def test_cpu_dispatch_takes_plain_version(committed_rungs):
    kernel.reset_launch_counts()
    for name in ("d3", "d3_state_probs"):
        for csg in committed_rungs[name]:
            tables = ExactTables(csg)
            x = _t(_rows(csg.n_params, 17, 1))
            np.testing.assert_array_equal(
                exact_eval.evaluate_abs_exact(tables, x).numpy(),
                evaluate.evaluate_abs(csg, x).numpy(),
            )
    assert kernel.launch_counts == dict.fromkeys(kernel.launch_counts, 0)
    with pytest.raises(ValueError, match="uint8"):
        exact_eval.evaluate_abs_exact(tables, torch.zeros((2, tables.n_params), dtype=torch.int32))


def test_kernel_configuration_matches_tsim_tpu():
    """Below 24 graphs tsim_tpu's evaluate_abs_auto takes the transposed
    kernel (K7a/K7b), otherwise the wide one (K5/K6)."""
    assert [kernel.configuration(g) for g in (1, 23, 24, 307)] == ["small", "small", "wide", "wide"]
    assert [kernel.graph_tile(g) for g in (24, 32, 60, 103, 172, 307)] == [32, 32, 64, 128, 128, 128]
    assert [kernel.num_tiles(g) for g in (6, 32, 172, 307)] == [1, 1, 2, 3]


def test_wrappers_refuse_cpu_tensors(committed_rungs):
    tables = ExactTables(committed_rungs["cultivation"][9])
    x = torch.zeros((2, tables.n_params), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.exact_partials(tables, x)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.approx_partials(tables, x)
