"""The closed-form tables of the approximate finisher (K6, K7b) against tsim_tpu.

``compile/closed_form.py`` turns a rung's node-phase family into packed
counters (zero count, count of ``c = 2 cos(pi / 8)``, half powers of two,
phase in sixteenths of a turn). Here, with inputs from a numpy seed:

* the float64 reader of the tables equals, graph by graph, the float64 value
  of the exact integers that ``tsim_tpu.compile.evaluate._evaluate_parts``
  gives, within 1e-12 relative, and is exactly zero where they are, on every
  approximate rung of d3 distillation and its state probabilities (compiled
  here by tsim_tpu) and on seeded rungs that use all eight node phases and all
  four families; rows are uniform and sparse (a few ones in a hundred, as the
  noise is), since uniform rows make most products of the wide rungs vanish;
* the float32 reader, which follows the kernel's arithmetic, agrees with
  ``tsim_tpu.compile.evaluate.evaluate_abs`` within rtol 1e-5 on the same rows;
* the float tables are the float64 ones rounded once; a count that does not
  fit its field raises at table build, naming G, T1 and the field;
* the stage split's variants and the wrapper's refusals;
* the least operations ``chip_smoke.py`` charges the approximate finisher per
  row, counted again here from the factor table on every approximate rung of
  the committed programs.
"""

import dataclasses
from fractions import Fraction

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from dev.export_torch_program import compile_d3, compile_d3_state_probs
from tsim_tpu.compile import evaluate as jax_evaluate
from tsim_tpu.compile.compile import compile_scalar_graphs
from tsim_tpu.zx.graph import ZXGraph
from tsim_tpu_torch.compile import closed_form
from tsim_tpu_torch.compile.exact_eval import evaluate_abs_exact
from tsim_tpu_torch.compile.exact_tables import ExactTables, exact_table_layout
from tsim_tpu_torch.compile.sample_eval import synthetic_rung
from tsim_tpu_torch.kernels import exact_eval as kernel
from tsim_tpu_torch.models.exported import distillation_d3
from tsim_tpu_torch.program_io import rung_from_reference

RTOL64, RTOL32 = 1e-12, 1e-5

# (program, rung) of every approximate rung of the committed programs.
APPROXIMATE_RUNGS = [("d3", i) for i in range(1, 6)] + [("d3_state_probs", 1)]


@pytest.fixture(scope="module")
def compiled():
    """tsim_tpu's rungs of d3 distillation and its state probabilities."""
    out = {}
    for name, make in (("d3", compile_d3), ("d3_state_probs", compile_d3_state_probs)):
        out[name] = [c for comp in make()._program.components for c in comp.compiled_scalar_graphs]
    return out


def _all_phase_rung(n_graphs: int, n_params: int, seed: int):
    """A tsim_tpu rung with approximate floatfactors whose graphs use all
    eight node phases, half-pi phases, pi products and phase pairs."""
    params = [f"f{i}" for i in range(n_params)]
    rng = np.random.default_rng(seed)

    def pick(lo, hi):
        return [params[i] for i in rng.choice(n_params, size=int(rng.integers(lo, hi + 1)), replace=False)]

    graphs = []
    for k in range(n_graphs):
        g = ZXGraph()
        for j in range(3 + k % 6):
            g.scalar.add_node(Fraction((k + 3 * j) % 8, 4), pick(1, 3))
        g.scalar.add_phase_pair(int(rng.integers(0, 8)), int(rng.integers(0, 8)), pick(1, 3), pick(1, 3))
        if k % 3:
            g.scalar.add_phase_pair(1, 6, pick(1, 2), pick(1, 2))
        g.scalar.add_halfpi(1 + k % 7, pick(1, 4))
        g.scalar.add_pi_pair(frozenset(pick(1, 3)), frozenset(pick(1, 3)))
        if k % 2:
            g.scalar.add_pi_var(pick(1, 2))
        g.scalar.power2 -= k % 5
        g.scalar.approximate_floatfactor = (0.5 + 0.1 * k) * complex(np.cos(0.7 * k), np.sin(0.7 * k))
        graphs.append(g)
    return compile_scalar_graphs(graphs, params)


SEEDED = {"small": (7, 9, 3), "wide": (40, 13, 4)}  # (graphs, parameters, seed)


def _rows(n_params: int, seed: int) -> np.ndarray:
    """48 uniform rows, then 80 sparse ones (each bit set with probability
    0.04), then the all-zero row."""
    rng = np.random.default_rng(seed)
    uniform = rng.integers(0, 2, size=(48, n_params))
    sparse = rng.random((80, n_params)) < 0.04
    return np.concatenate([uniform, sparse, np.zeros((1, n_params))]).astype(np.uint8)


@jax.jit
def _exact_parts(csg, rows):
    total = jax_evaluate._evaluate_parts(csg, rows)
    return total.coeffs, total.power + csg.prefactor.power2


def _graph_values_float64(csg, rows: np.ndarray) -> np.ndarray:
    """(B, G) complex128: tsim_tpu's exact integers per graph, converted in
    float64, times the approximate factor."""
    coeffs, power = (np.asarray(a) for a in _exact_parts(csg, rows))
    c = coeffs.astype(np.float64)
    r = np.sqrt(0.5)
    value = (c[0] + (c[1] - c[3]) * r) + 1j * (c[2] + (c[1] + c[3]) * r)
    approx = np.asarray(csg.prefactor.approximate_floatfactors, np.float64)
    return value * np.exp2(power.astype(np.float64)) * (approx[:, 0] + 1j * approx[:, 1])[None]


def _check_tables_against_tsim_tpu(csg) -> float:
    """Both readers on one rung; returns the share of vanishing products."""
    assert csg.prefactor.has_approximate_floatfactors
    tables = ExactTables(rung_from_reference(csg))
    rows = _rows(csg.n_params, seed=csg.num_graphs)
    x = torch.from_numpy(rows)
    want = _graph_values_float64(csg, rows)
    re, im = closed_form.closed_form_graph_values(tables, x, torch.float64)
    got = re.numpy() + 1j * im.numpy()
    assert got.shape == want.shape == (rows.shape[0], csg.num_graphs)
    np.testing.assert_array_equal(got == 0, want == 0)  # zero products exactly zero
    assert (np.abs(got - want) <= RTOL64 * np.abs(want)).all()

    want_abs = np.asarray(jax_evaluate.evaluate_abs(csg, rows))
    got_abs = closed_form.closed_form_abs(tables, x, torch.float32).numpy()
    assert got_abs.dtype == np.float32
    np.testing.assert_allclose(got_abs, want_abs, rtol=RTOL32, atol=0)
    return float((want == 0).mean())


@pytest.mark.parametrize("program,rung", APPROXIMATE_RUNGS, ids=[f"{p}[{r}]" for p, r in APPROXIMATE_RUNGS])
def test_closed_form_matches_exact_integers_on_committed_rungs(compiled, program, rung):
    vanishing = _check_tables_against_tsim_tpu(compiled[program][rung])
    if program == "d3_state_probs":
        assert 0.5 < vanishing < 1.0  # some products vanish and some do not


@pytest.mark.parametrize("case", sorted(SEEDED))
def test_closed_form_matches_exact_integers_on_seeded_rungs(case):
    n_graphs, n_params, seed = SEEDED[case]
    csg = _all_phase_rung(n_graphs, n_params, seed)
    live = np.arange(csg.node_phases.phases.shape[0])[:, None] < np.asarray(csg.node_phases.counts)[None]
    assert set(np.asarray(csg.node_phases.phases)[live] & 7) == set(range(8))
    tables = ExactTables(rung_from_reference(csg))
    assert min(tables.dims) > 0 and kernel.configuration(tables.num_graphs) == case
    vanishing = _check_tables_against_tsim_tpu(csg)
    assert 0.0 < vanishing < 1.0


@pytest.mark.parametrize("k", range(8))
def test_factor_table_is_one_plus_omega_to_the_k(k):
    """FACTORS[k] describes 1 + w^k: zero, or c^e sqrt(2)^h e^{i pi phi / 8}."""
    z, e, h, phi = closed_form.FACTORS[k]
    want = 1 + np.exp(1j * np.pi * k / 4)
    got = 0 if z else closed_form.C ** float(e) * np.sqrt(2.0) ** h * np.exp(1j * np.pi * phi / 8)
    assert abs(got - want) < 1e-14 and (z == 1) == (k == 4)


def test_float_tables_are_rounded_once_from_float64():
    unit = closed_form.unit_table()
    assert unit.dtype == np.float32 and unit.shape == (16, 2)
    np.testing.assert_array_equal(unit, closed_form.unit_table(np.float64).astype(np.float32))
    np.testing.assert_array_equal(unit[[0, 4, 8, 12]], [[1, 0], [0, 1], [-1, 0], [0, -1]])
    mag = closed_form.magnitude_table(3)
    assert mag.shape == (7, 2) and mag[3, 0] == 1.0 and mag[3, 1] == np.float32(np.sqrt(2.0))
    np.testing.assert_allclose(mag[4, 0] * mag[2, 0], 1.0, rtol=2e-7)
    assert abs(closed_form.C * 2 * np.cos(3 * np.pi / 8) - np.sqrt(2.0)) < 1e-15


def test_closed_form_segments_follow_the_layout(compiled):
    """An approximate rung's buffer holds the closed-form segments between the
    integer tables and the lists, and no node-phase fold; an exact rung's has
    no closed-form segments, and its fold after the lists."""
    tables = ExactTables(rung_from_reference(compiled["d3_state_probs"][1]))
    tc, bias = tables.closed_form
    assert tc == 18 == int(np.max(compiled["d3_state_probs"][1].node_phases.counts)) and bias >= 1
    names = [name for name, _, _ in tables.layout()]
    assert names.index("pf_pow") < names.index("cf_delta") < names.index("cf_mag") < names.index("bs_base")
    views = tables.views()
    assert views["cf_delta"].shape == (tc, 172) and views["cf_base"].shape == (172,)
    assert views["cf_pre"].dtype == torch.float32 and views["cf_mag"].shape == (2 * bias + 1, 2)
    assert tables.flat.numel() == sum(int(np.prod(shape)) for _, shape, _ in tables.layout())
    dead = np.arange(tc)[:, None] >= np.asarray(compiled["d3_state_probs"][1].node_phases.counts)[None]
    assert not views["cf_delta"].numpy()[dead].any()  # a dead term carries a zero increment

    exact = ExactTables(rung_from_reference(compiled["d3_state_probs"][0]))
    assert tables.fold is None and not any(n.startswith("nf_") for n in names)
    exact = ExactTables(rung_from_reference(compiled["d3_state_probs"][0]))
    assert exact.closed_form is None and not any(n.startswith("cf_") for n, _, _ in exact.layout())
    assert exact.layout() == exact_table_layout(
        *exact.dims, exact.num_graphs, exact.words, exact.list_words, fold=exact.fold
    )
    names = [name for name, _, _ in exact.layout()]
    assert names.index("bs_words") < names.index("nf_phases") < names.index("nv_base") and names[-1] == "nv_words"


def _rung_of_one_phase(t1: int, phase: int, approximate: bool = True):
    """One graph of ``t1`` live node-phase terms, all of phase ``phase``."""
    rung = synthetic_rung(0, 1, 4, (t1, 1, 1, 1))
    node = dataclasses.replace(
        rung.node_phases, phases=np.full((t1, 1), phase, np.int32), counts=np.full(1, t1, np.int32)
    )
    prefactor = dataclasses.replace(
        rung.prefactor, has_approximate_floatfactors=approximate, power2=np.full(1, -t1, np.int32)
    )
    return dataclasses.replace(rung, node_phases=node, prefactor=prefactor)


@pytest.mark.parametrize(
    "t1,phase,field",
    [(512, 0, "zero count"), (300, 0, "half powers of two"), (600, 1, "count of c"), (200, 1, "float32 range")],
)
def test_field_overflow_raises(t1, phase, field):
    """A count that cannot fit its field, or a power of c beyond float32,
    refuses the rung at table build and names G, T1 and the field."""
    with pytest.raises(ValueError, match=field) as err:
        ExactTables(_rung_of_one_phase(t1, phase))
    assert "1 graphs" in str(err.value) and f"T1 = {t1}" in str(err.value)
    ExactTables(_rung_of_one_phase(t1, phase, approximate=False))  # an exact rung has no such fields


def test_counts_at_the_fields_edge_build():
    tables = ExactTables(_rung_of_one_phase(255, 0))  # 510 half powers of two, 255 zeros at most
    assert tables.closed_form == (255, 0)
    x = torch.zeros((1, 4), dtype=torch.uint8)
    np.testing.assert_allclose(
        closed_form.closed_form_abs(tables, x, torch.float64).numpy(),
        evaluate_abs_exact(tables, x).numpy().astype(np.float64), rtol=1e-6,
    )


def test_stage_split_names_and_refusals():
    assert kernel.APPROX_ABLATION_VARIANTS == ("empty", "par-all", "full")
    assert set(kernel.launch_counts) == {*kernel.KERNELS, "approx_ablate"}
    tables = ExactTables(_rung_of_one_phase(2, 1))
    x = torch.zeros((3, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.ablate_approx(tables, x, "full")
    with pytest.raises(ValueError, match="variant"):
        kernel.ablate_approx(tables, x, "par1")


@pytest.mark.parametrize("program,rung", APPROXIMATE_RUNGS, ids=[f"{p}[{r}]" for p, r in APPROXIMATE_RUNGS])
def test_least_operations_of_the_approximate_finisher(program, rung):
    """The bound's operation count charges a row one operation only for a node
    phase whose factor needs a value per shot: a term one of whose two factors
    vanishes (phase 0 or 4: 2 or 0) is a bit-sliced OR, as half-pi terms and pi
    products are bit-sliced; phase pairs cost what the exact bound says."""
    d3 = distillation_d3(p=0.05)
    exported = d3.load() if program == "d3" else d3.load_state_probs()
    c = exported.program.components[0].compiled_scalar_graphs[rung]
    phases = np.asarray(c.node_phases.phases) & 7
    live = np.arange(phases.shape[0])[:, None] < np.asarray(c.node_phases.counts)[None]
    vanishing = (closed_form.FACTORS[phases, 0] | closed_form.FACTORS[(phases + 4) & 7, 0]).astype(bool)
    n1, n2, n3, n4 = chip_smoke.live_terms(c)
    assert n1 == live.sum()
    sliced = int((live & vanishing).sum())
    want = (n1 - sliced) + 12 * n4 + (sliced + n2 + n3 + chip_smoke.parity_bits(c)) / 32
    got = chip_smoke.approx_operations(c)
    assert got == want
    assert got >= chip_smoke.parity_bits(c) / 32 + n4
    if program == "d3_state_probs":
        assert (n1, n2, n3, n4, got) == (2761, 375, 409, 86, 2033.0625)
    tables = ExactTables(c)
    ms, by = chip_smoke.approx_bound(c, tables, (1 << 20) + 1)
    as_exact, _ = chip_smoke.exact_bound(c, tables, (1 << 20) + 1)
    assert 0 < ms <= as_exact and by in ("bytes", "operations")
