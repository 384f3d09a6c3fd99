"""The bit-sliced parity front end of the wide kernels, on the CPU.

The wide CUDA kernels (``kernels/csrc/bitsliced.cuh``) form a graph's
parities for 32 shots at once from lists of each mask's set parameters
(``compile/bit_lists.py``). Here:

* the lists are held against the packed mask words of the same table buffer
  (every wide rung of the four committed programs, and seeded rungs over 7 to
  200 parameters with empty masks and dead rows mixed in): they name exactly
  the set bits; empty and dead rows have empty lists;
* the plain numpy front end (bit planes, XOR by the lists, ripple-carry
  half-pi total, pi-product sign) is held against the ``x @ params mod 2``
  route of the plain versions, ragged last groups included, on seeded rungs,
  on every small rung (which the small f32 kernel K2 reads), on every exact
  small rung (which the small exact kernel K7a reads) and on every
  approximate small rung (K7b). The CUDA code is written from that function; on the card the kernels are held against the
  plain versions (``tests/test_torch_kernels.py``, ``chip_smoke.py``);
* K7b's arithmetic: the plain front end's bits, fed to the float32
  closed-form reader (``compile/closed_form.py``), against the plain
  approximate evaluator on every approximate small rung and on seeded ones of
  130, 200 and 300 parameters;
* the wide f32 kernel's instance (32 or 128 shots a block) follows the row
  count;
* rungs over 128 parameters, which the exact tables refused before, are held
  against ``tsim_tpu.compile.evaluate.evaluate_abs``: integer for integer on
  exact rungs (``test_torch_exact_eval._check_rung``), within 1e-6 on
  approximate ones; inputs from a numpy seed;
* nothing under ``tsim_tpu_torch/`` nor ``chip_smoke.py`` imports ``jax`` or
  ``tsim_tpu``.
"""

import ast
import dataclasses
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

from tsim_tpu.compile.compile import compile_scalar_graphs
from tsim_tpu.zx.graph import ZXGraph
from tests.test_torch_exact_eval import APPROX_RTOL, _check_rung
from tsim_tpu_torch.compile import bit_lists, closed_form, evaluate
from tsim_tpu_torch.compile.exact_eval import evaluate_abs_exact
from tsim_tpu_torch.compile.exact_tables import ExactTables
from tsim_tpu_torch.compile.sample_eval import PROBE_ROWS, synthetic_rung
from tsim_tpu_torch.compile.sample_tables import SampleTables, unpack_words
from tsim_tpu_torch.kernels import exact_eval as exact_kernel
from tsim_tpu_torch.kernels import sample_eval as kernel
from tsim_tpu_torch.models.exported import cultivation_d3, distillation_d3
from tsim_tpu_torch.program_io import rung_from_reference

REPO = Path(__file__).resolve().parents[1]

# (program, rung) of every rung of the committed programs that takes the wide kernels.
WIDE_RUNGS = (
    [("d3", i) for i in (3, 4, 5)]
    + [("d3_state_probs", 1)]
    + [("cultivation", i) for i in range(2, 10)]
    + [("cultivation_checks1", 8)]
)
SEEDED_PARAMS = (7, 33, 64, 130, 200)

# (program, rung) of every rung that takes the small kernels: the small f32
# kernel deals the same lists out a thread a mask.
SMALL_RUNGS = (
    [("d3", i) for i in range(3)]
    + [("d3_state_probs", 0)]
    + [("cultivation", i) for i in range(2)]
    + [("cultivation_checks1", i) for i in range(8)]
)


# (program, rung) of every rung under 24 graphs without approximate
# floatfactors of the three programs that evaluate exactly: the small exact
# kernel (K7a) reads the same front end as K2.
EXACT_SMALL_RUNGS = [("d3", 0), ("d3_state_probs", 0), ("cultivation", 0), ("cultivation", 1)]

# (program, rung) of every rung under 24 graphs with approximate floatfactors:
# the small approximate kernel (K7b) reads the same front end.
APPROX_SMALL_RUNGS = [("d3", 1), ("d3", 2)]


@pytest.fixture(scope="module")
def programs():
    loaded = {
        "d3": distillation_d3(p=0.05).load(),
        "d3_state_probs": distillation_d3(p=0.05).load_state_probs(),
        "cultivation": cultivation_d3(p=0.001, checks=2).load(),
        "cultivation_checks1": cultivation_d3(p=0.001, checks=1).load(),
    }
    return {
        name: [c for comp in e.program.components for c in comp.compiled_scalar_graphs]
        for name, e in loaded.items()
    }


def _sparse_rung(n_params: int, seed: int, num_graphs: int = 40):
    """A seeded rung of every family whose masks are thinned: a third of the
    rows get an empty mask, the rest keep about one parameter in five."""
    rung = synthetic_rung(seed, num_graphs, n_params, (3, 5, 4, 2))
    rng = np.random.default_rng(1000 + seed)

    def thin(params):
        keep = rng.random(params.shape) < 0.2
        keep &= rng.random(params.shape[:2])[..., None] > 1 / 3
        return params * keep

    def thinned(family, names):
        return dataclasses.replace(family, **{n: thin(getattr(family, n)) for n in names})

    return dataclasses.replace(
        rung,
        node_phases=thinned(rung.node_phases, ["params"]),
        halfpi_phases=thinned(rung.halfpi_phases, ["params"]),
        pi_products=thinned(rung.pi_products, ["psi_params", "phi_params"]),
        phase_pairs=thinned(rung.phase_pairs, ["alpha_params", "beta_params"]),
    )


def _lists_of(tables) -> dict:
    v = tables.views()
    return {k: v[k].numpy() for k in ("bs_base", "bs_meta", "bs_words")}


def _row_sets(lists: dict, n_params: int, row: int) -> list:
    """Per graph, the tuple of parameters row ``row``'s list names; the rest
    of the row's slot must be padding, and the slot no longer than needed."""
    base, meta = lists["bs_base"], lists["bs_meta"]
    counts = meta[row] & 0xFFFF
    per_word = 4 // bit_lists.index_bytes(n_params)
    assert base[row + 1] - base[row] == -(-counts.max(initial=0) // per_word)
    entries = bit_lists.row_entries(lists, n_params, row)  # (slot, G)
    for g in range(meta.shape[1]):
        assert (entries[counts[g] :, g] == n_params).all()  # the zero plane
    return [tuple(entries[: counts[g], g]) for g in range(meta.shape[1])]


def _set_bits(words: torch.Tensor, n_params: int) -> list:
    """(G, W) packed words -> per graph the tuple of set parameters, ascending."""
    return [tuple(np.flatnonzero(b)) for b in unpack_words(words, n_params).numpy()]


def _check_lists(tables) -> None:
    """The bit lists of ``tables`` against the packed words of the same buffer."""
    v, lists = tables.views(), _lists_of(tables)
    t1, t2, t3, t4 = tables.dims
    G, P = tables.num_graphs, tables.n_params
    aux = lists["bs_meta"] >> 16
    exact = isinstance(tables, ExactTables)
    R = t1 + t2 + 2 * t3 + 2 * t4
    base = lists["bs_base"]
    assert base[0] == 0 and lists["bs_words"].shape == (base[R] + bit_lists.AHEAD, G) and tables.list_words == base[R]
    assert lists["bs_meta"].shape[0] == R
    pad = sum(P << (8 * bit_lists.index_bytes(P) * k) for k in range(4 // bit_lists.index_bytes(P)))
    assert (lists["bs_words"][base[R] :].view(np.uint32) == pad).all()  # the stream's closing words

    # Node phases and phase pairs: table order, empty past the graph's count.
    if exact:
        live1 = torch.arange(t1)[:, None] < v["np_counts"][None]
        live4 = torch.arange(t4)[:, None] < v["qp_counts"][None]
    else:
        live1 = (v["np_cos"] != 0) | (v["np_sin"] != 0)
        live4 = (v["qp_ca"] != 0) | (v["qp_sa"] != 0)
    for t in range(t1):
        want = _set_bits(v["np_words"][t], P)
        got = _row_sets(lists, P, t)
        for g in range(G):
            if live1[t, g]:
                assert got[g] == want[g]
            else:  # a dead slot's factor is 1 whatever its parity: its list may be empty
                assert got[g] in ((), want[g])
    first = t1 + t2 + 2 * t3
    for t in range(t4):
        for side, name in enumerate(("qp_alpha_words", "qp_beta_words")):
            want, got = _set_bits(v[name][t], P), _row_sets(lists, P, first + 2 * t + side)
            for g in range(G):
                assert got[g] == want[g] or (not live4[t, g] and got[g] == ())
    assert not aux[:t1].any() and not aux[first:].any()

    # Half-pi rows: each graph's live rows as a multiset of (coefficient, mask),
    # in any order, within the live length; nothing after it.
    coeffs = v["hp_coeffs"].numpy() & 7
    masks = [_set_bits(v["hp_words"][t], P) for t in range(t2)]
    listed = [_row_sets(lists, P, t1 + r) for r in range(t2)]
    for g in range(G):
        want = sorted((coeffs[t, g], masks[t][g]) for t in range(t2) if coeffs[t, g] and masks[t][g])
        got = [(aux[t1 + r, g], listed[r][g]) for r in range(t2)]
        n = sum(1 for a, m in got if a or m)
        assert n <= base[R + 1] and sorted(got[:n]) == want  # live rows first
        assert all(a == 0 and m == () for a, m in got[n:])
        weights = [len(m) for _, m in got[:n]]
        assert weights == sorted(weights, reverse=True)

    # Pi products: each graph's live terms as a multiset of unordered pairs of
    # (constant, mask) sides.
    pc, qc = v["pp_psi_c"].numpy() & 1, v["pp_phi_c"].numpy() & 1
    psi = [_set_bits(v["pp_psi_words"][t], P) for t in range(t3)]
    phi = [_set_bits(v["pp_phi_words"][t], P) for t in range(t3)]
    first = t1 + t2
    listed = [_row_sets(lists, P, first + r) for r in range(2 * t3)]
    for g in range(G):
        want = sorted(
            tuple(sorted([(pc[t, g], psi[t][g]), (qc[t, g], phi[t][g])]))
            for t in range(t3)
            if (pc[t, g] or psi[t][g]) and (qc[t, g] or phi[t][g])
        )
        got = [
            tuple(sorted([(aux[first + 2 * r, g], listed[2 * r][g]), (aux[first + 2 * r + 1, g], listed[2 * r + 1][g])]))
            for r in range(t3)
        ]
        n = sum(1 for a, b in got if a != (0, ()) or b != (0, ()))
        assert n <= base[R + 2] and sorted(got[:n]) == want
        assert all(a == (0, ()) and b == (0, ()) for a, b in got[n:])


@pytest.mark.parametrize("program,rung", WIDE_RUNGS, ids=[f"{p}[{r}]" for p, r in WIDE_RUNGS])
def test_lists_name_the_set_bits_of_committed_rungs(programs, program, rung):
    csg = programs[program][rung]
    assert kernel.layout(csg.num_graphs) == "wide"
    exact = ExactTables(csg)
    _check_lists(exact)
    if program != "d3_state_probs":
        f32 = SampleTables(csg)
        _check_lists(f32)
        for name, seg in _lists_of(f32).items():  # one function builds both: the same lists in both buffers
            np.testing.assert_array_equal(seg, _lists_of(exact)[name])


@pytest.mark.parametrize("program,rung", SMALL_RUNGS, ids=[f"{p}[{r}]" for p, r in SMALL_RUNGS])
def test_lists_name_the_set_bits_of_small_rungs(programs, program, rung):
    """The small f32 kernel reads the same lists, a thread a (row, graph)
    mask: they name the set bits on every rung under 24 graphs too, and the
    plain front end gives the parities of ``x @ params mod 2`` there."""
    csg = programs[program][rung]
    assert kernel.layout(csg.num_graphs) == "small"
    _check_lists(ExactTables(csg))
    if program != "d3_state_probs":
        _check_lists(SampleTables(csg))
    _check_front_end(csg, 65, seed=rung)


def test_exact_small_rungs_are_all_listed(programs):
    found = [
        (name, i) for name in ("d3", "d3_state_probs", "cultivation") for i, c in enumerate(programs[name])
        if exact_kernel.configuration(c.num_graphs) == "small" and not ExactTables(c).approximate
    ]
    assert found == EXACT_SMALL_RUNGS


@pytest.mark.parametrize("batch", [1, 31, 33, 129])
@pytest.mark.parametrize("program,rung", EXACT_SMALL_RUNGS, ids=[f"{p}[{r}]" for p, r in EXACT_SMALL_RUNGS])
def test_plain_front_end_matches_parity_route_on_exact_small_rungs(programs, program, rung, batch):
    """The small front end over the exact tables' lists gives the parities,
    half-pi totals and pi-product signs of ``x @ params mod 2`` on every exact
    small rung, term-free ones included, whole and ragged 32-shot groups."""
    csg = programs[program][rung]
    _check_lists(ExactTables(csg))
    _check_front_end(csg, batch, seed=batch)


def test_approximate_small_rungs_are_all_listed(programs):
    found = [
        (name, i) for name in ("d3", "d3_state_probs", "cultivation") for i, c in enumerate(programs[name])
        if exact_kernel.configuration(c.num_graphs) == "small" and ExactTables(c).approximate
    ]
    assert found == APPROX_SMALL_RUNGS


@pytest.mark.parametrize("batch", [1, 31, 33, 129])
@pytest.mark.parametrize("program,rung", APPROX_SMALL_RUNGS, ids=[f"{p}[{r}]" for p, r in APPROX_SMALL_RUNGS])
def test_plain_front_end_matches_parity_route_on_approximate_small_rungs(programs, program, rung, batch):
    """The same on the approximate small rungs, whose tables also hold the
    closed-form segments before the lists."""
    csg = programs[program][rung]
    _check_lists(ExactTables(csg))
    _check_front_end(csg, batch, seed=batch)


def _approximate(rung, seed: int):
    """``rung`` with seeded approximate floatfactors."""
    factors = np.random.default_rng(seed).normal(size=(rung.num_graphs, 2)).astype(np.float32)
    return dataclasses.replace(rung, prefactor=dataclasses.replace(
        rung.prefactor, approximate_floatfactors=factors, has_approximate_floatfactors=True))


def _approximate_small_rung(programs, name: str):
    if name.startswith("seeded"):
        n_params = int(name.split("=")[1])
        return _approximate(synthetic_rung(n_params + 5, 5, n_params, (6, 4, 4, 2)), seed=n_params)
    program, rung = name.rstrip("]").split("[")
    return programs[program][int(rung)]


@pytest.mark.parametrize("batch", [1, 33, 129])
@pytest.mark.parametrize("name", [*(f"{p}[{r}]" for p, r in APPROX_SMALL_RUNGS), "seeded P=130",
                                  "seeded P=200", "seeded P=300"])
def test_front_end_bits_through_closed_form_reader(programs, name, batch):
    """K7b's arithmetic on the CPU: the plain front end's per-shot bits, the
    ones ``ShotRows`` reads (node-phase list row t for the closed-form slot
    t), fed to the float32 closed-form reader, equal the plain approximate
    evaluator within APPROX_RTOL (1e-6, inside the card's gate of 1e-5) of the
    row's magnitude, on every approximate small rung and on seeded ones of one-
    and two-byte list indices."""
    csg = _approximate_small_rung(programs, name)
    tables = ExactTables(csg)
    assert tables.approximate and exact_kernel.configuration(tables.num_graphs) == "small"
    x = np.random.default_rng(batch).integers(0, 2, size=(batch, tables.n_params), dtype=np.uint8)
    front = bit_lists.sliced_front_end(_lists_of(tables), tables.dims, x)
    parities = {k: torch.from_numpy(np.asarray(v)) for k, v in front.items()}
    xt = torch.from_numpy(x)
    got = closed_form.closed_form_abs(tables, xt, torch.float32, parities)
    want = evaluate.evaluate_abs(tables.circuit(), xt)
    assert got.dtype == torch.float32 and got.shape == (batch,)
    err = (got - want).abs()
    assert bool((err <= 1e-8 + APPROX_RTOL * want).all()), float((err / want.clamp_min(1e-30)).max())
    np.testing.assert_array_equal(got.numpy(), closed_form.closed_form_abs(tables, xt, torch.float32).numpy())


@pytest.mark.parametrize("n_params", [160, 300])
def test_small_rungs_of_many_parameters(n_params):
    """Small rungs past four packed words, with one- and two-byte indices."""
    rung = _sparse_rung(n_params, seed=n_params, num_graphs=8)
    assert kernel.configuration(rung.num_graphs) == "small"
    _check_lists(SampleTables(rung))
    _check_front_end(rung, 129, seed=3)


def test_term_free_rung_has_an_empty_stream(programs):
    """Rung 0 of every program is one graph without terms: no list rows, so
    the small kernel builds no planes for it."""
    for name, rungs in programs.items():
        tables = ExactTables(rungs[0])
        assert tables.dims == (0, 0, 0, 0) and tables.list_words == 0, name
        lists = _lists_of(tables)
        assert lists["bs_base"].tolist() == [0, 0, 0] and lists["bs_meta"].shape == (0, 1)


@pytest.mark.parametrize("n_params", SEEDED_PARAMS)
def test_lists_name_the_set_bits_of_seeded_rungs(n_params):
    rung = _sparse_rung(n_params, seed=n_params)
    tables = ExactTables(rung)
    assert tables.words == -(-n_params // 32)
    _check_lists(tables)
    _check_lists(SampleTables(rung))
    meta = _lists_of(tables)["bs_meta"]
    assert (meta & 0xFFFF == 0).mean() > 0.2  # the thinning left empty rows


def test_index_width_follows_the_parameter_count():
    """One byte an index while P and the zero plane's index fit a byte, two beyond."""
    assert [bit_lists.index_bytes(p) for p in (1, 42, 255, 256, 4000)] == [1, 1, 1, 2, 2]
    rung = _sparse_rung(300, seed=3, num_graphs=24)
    tables = ExactTables(rung)
    _check_lists(tables)
    _check_front_end(rung, 33, seed=2)


def test_all_zero_masks_have_empty_lists(programs):
    """About half of cultivation's parity rows are padding: no list entry for them."""
    csg = programs["cultivation"][9]
    lists = _lists_of(SampleTables(csg))
    counts = lists["bs_meta"] & 0xFFFF
    assert counts.shape == (117, 307)
    assert 0.4 < (counts == 0).mean() < 0.6
    assert int(counts.sum()) <= 482 * 307 + 307  # about 482 set bits a graph
    assert bit_lists.index_bytes(csg.n_params) == 1 and lists["bs_words"].shape[0] - bit_lists.AHEAD == 323


def test_wide_instance_follows_the_row_count():
    """Below WIDE_SMALL_ROWS rows "wide" takes 32 shots a block, from it on
    128; a launch takes at least one row. The self-test's probe takes the
    32-shot block, as a user's launch of its rows does."""
    n = kernel.WIDE_SMALL_ROWS
    assert kernel.WIDE_BLOCK_SHOTS == (32, 128) and 128 < n <= 1 << 20
    assert [kernel.wide_block_shots(r) for r in (1, 31, 33, PROBE_ROWS, n - 1)] == [32] * 5
    assert [kernel.wide_block_shots(r) for r in (n, n + 1, (1 << 20) + 1)] == [128] * 3
    for rows in (0, -1):
        with pytest.raises(ValueError, match="at least one row"):
            kernel.wide_block_shots(rows)


def test_only_wide_takes_a_forced_block(programs):
    """The private ``_block_shots`` forces one of wide's two instances and
    nothing else; it is refused before any device is touched."""
    tables = SampleTables(programs["d3"][3])
    x = torch.zeros((4, tables.n_params), dtype=torch.uint8)
    for config, shots in (("small", 32), ("per_term_wide", 128), ("wide", 64), ("wide", 0)):
        with pytest.raises(ValueError, match="block"):
            kernel.launch(tables, x, config, _block_shots=shots)
    with pytest.raises(ValueError, match="CUDA"):  # a valid instance reaches the device check
        kernel.launch(tables, x, "wide", _block_shots=32)


def _parity_route(rung, x: np.ndarray) -> dict:
    """Per-shot parities, half-pi totals and pi-product signs by
    ``x @ params mod 2``, as the plain versions form them."""
    x = x.astype(np.int64)

    def par(params):  # (T, G, P) -> (B, T, G)
        return np.einsum("bp,tgp->btg", x, np.asarray(params, np.int64)) & 1

    hp, pp, qp = rung.halfpi_phases, rung.pi_products, rung.phase_pairs
    live1 = np.arange(np.shape(rung.node_phases.params)[0])[:, None] < np.asarray(rung.node_phases.counts)[None]
    live4 = np.arange(np.shape(qp.alpha_params)[0])[:, None] < np.asarray(qp.counts)[None]
    tot = (par(hp.params) * np.asarray(hp.coeffs, np.int64)[None]).sum(axis=1) & 7
    psi = par(pp.psi_params) ^ (np.asarray(pp.psi_const, np.int64)[None] & 1)
    phi = par(pp.phi_params) ^ (np.asarray(pp.phi_const, np.int64)[None] & 1)
    return dict(
        node=par(rung.node_phases.params) * live1[None],
        alpha=par(qp.alpha_params) * live4[None],
        beta=par(qp.beta_params) * live4[None],
        tot=tot,
        sign=(psi & phi).sum(axis=1) & 1,
    )


def _check_front_end(rung, batch: int, seed: int) -> None:
    x = np.random.default_rng(seed).integers(0, 2, size=(batch, rung.n_params), dtype=np.uint8)
    tables = ExactTables(rung)
    got = bit_lists.sliced_front_end(_lists_of(tables), tables.dims, x)
    want = _parity_route(rung, x)
    assert set(got) == set(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("batch", [1, 32, 33, 65])
@pytest.mark.parametrize("n_params", SEEDED_PARAMS)
def test_plain_front_end_matches_parity_route(n_params, batch):
    _check_front_end(_sparse_rung(n_params, seed=n_params, num_graphs=24), batch, seed=batch)


@pytest.mark.parametrize("program,rung", [("cultivation", 9), ("cultivation_checks1", 8), ("d3", 5)])
def test_plain_front_end_matches_parity_route_on_committed_rungs(programs, program, rung):
    _check_front_end(programs[program][rung], 65, seed=rung)


def test_planes_pack_32_shots_a_word():
    x = np.random.default_rng(0).integers(0, 2, size=(70, 5), dtype=np.uint8)
    planes = bit_lists.pack_planes(x)
    assert planes.shape == (3, 5) and planes.dtype == np.uint32
    assert planes[2].max() < 1 << 6  # shots past the end of the batch are 0
    np.testing.assert_array_equal(bit_lists.unpack_shots(planes, 70), x)
    assert (planes[1, 3] >> 4) & 1 == x[32 + 4, 3]


@pytest.mark.parametrize("coeff", range(8))
def test_ripple_add_counts_mod_8(coeff):
    rng = np.random.default_rng(coeff)
    tot = [rng.integers(0, 1 << 32, size=(2, 3), dtype=np.uint64).astype(np.uint32) for _ in range(3)]
    before = sum(bit_lists.unpack_shots(t, 64).astype(np.int64) << k for k, t in enumerate(tot))
    w = rng.integers(0, 1 << 32, size=(2, 3), dtype=np.uint64).astype(np.uint32)
    bit_lists.ripple_add(tot, w, np.full(3, coeff))
    after = sum(bit_lists.unpack_shots(t, 64).astype(np.int64) << k for k, t in enumerate(tot))
    np.testing.assert_array_equal(after, (before + coeff * bit_lists.unpack_shots(w, 64)) & 7)


# ------------------------------------------------- rungs over 128 parameters

def _tsim_rung(n_params: int, n_graphs: int, seed: int, approximate: bool = False):
    """A tsim_tpu rung of ``n_graphs`` graphs with all four term families,
    whose terms reach parameters up to ``n_params - 1``."""
    params = [f"f{i}" for i in range(n_params)]
    rng = np.random.default_rng(seed)

    def pick(lo, hi):
        return [params[i] for i in rng.choice(n_params, size=int(rng.integers(lo, hi + 1)), replace=False)]

    graphs = []
    for k in range(n_graphs):
        g = ZXGraph()
        for j in range(k % 3 + 1):
            g.scalar.add_node(Fraction(1, 4) * (2 * j + 1), pick(1, 6))
        g.scalar.add_phase_pair(int(rng.integers(0, 8)), int(rng.integers(0, 8)), pick(1, 4), pick(1, 4))
        if k % 4:
            g.scalar.add_phase_pair(1, 7, [params[-1], params[k]], pick(1, 3))
        g.scalar.add_halfpi(1 + 2 * (k % 2), [params[n_params - 1 - k], *pick(1, 5)])
        g.scalar.add_halfpi(3, pick(1, 9))
        g.scalar.add_pi_pair(frozenset(pick(1, 5)), frozenset(pick(1, 5)))
        if k % 2:
            g.scalar.add_pi_var(pick(1, 3))
        g.scalar.power2 -= k % 3
        if approximate:
            g.scalar.approximate_floatfactor = 0.9 * complex(np.cos(0.3 * k + 0.1), np.sin(0.3 * k + 0.1))
        graphs.append(g)
    return compile_scalar_graphs(graphs, params)


@pytest.mark.parametrize("n_graphs", [5, 40])
@pytest.mark.parametrize("n_params", [130, 200])
def test_exact_rungs_over_128_parameters_match_tsim_tpu(n_params, n_graphs):
    """Integer for integer against tsim_tpu's exact evaluator, through the
    plain version and through the tables' round trip (CPU dispatch)."""
    csg = _tsim_rung(n_params, n_graphs, seed=n_params + n_graphs)
    assert csg.n_params == n_params and not csg.prefactor.has_approximate_floatfactors
    rows = np.random.default_rng(n_graphs).integers(0, 2, size=(33, n_params), dtype=np.uint8)
    assert rows[:, 128:].any()
    _check_rung(csg, rows)
    port = rung_from_reference(csg)
    tables = ExactTables(port)
    assert tables.words == -(-n_params // 32) > 4
    assert min(tables.dims) > 0  # all four families
    assert exact_kernel.configuration(tables.num_graphs) == ("small" if n_graphs == 5 else "wide")
    x = torch.from_numpy(rows)
    np.testing.assert_array_equal(
        evaluate_abs_exact(tables, x).numpy(), evaluate.evaluate_abs(port, x).numpy()
    )
    _check_lists(tables)
    _check_front_end(port, 33, seed=1)


@pytest.mark.parametrize("n_graphs", [5, 40])
@pytest.mark.parametrize("n_params", [130, 200])
def test_approximate_rungs_over_128_parameters_match_tsim_tpu(n_params, n_graphs):
    csg = _tsim_rung(n_params, n_graphs, seed=n_params + n_graphs, approximate=True)
    assert csg.prefactor.has_approximate_floatfactors
    rows = np.random.default_rng(n_graphs).integers(0, 2, size=(33, n_params), dtype=np.uint8)
    _check_rung(csg, rows)
    tables = ExactTables(rung_from_reference(csg))
    assert tables.approximate and tables.words > 4
    from tsim_tpu.compile.evaluate import evaluate_abs as jax_evaluate_abs

    np.testing.assert_allclose(
        evaluate_abs_exact(tables, torch.from_numpy(rows)).numpy(),
        np.asarray(jax_evaluate_abs(csg, rows)), rtol=APPROX_RTOL, atol=0,
    )


# ------------------------------------------------------------ no JAX in the port

def _imported_modules(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def test_the_port_imports_neither_jax_nor_tsim_tpu():
    files = [*sorted((REPO / "tsim_tpu_torch").rglob("*.py")), REPO / "chip_smoke.py",
             REPO / "dev" / "torch_kernel_ablate.py", REPO / "dev" / "torch_profile_d3.py",
             REPO / "dev" / "torch_walk_variant.py", REPO / "dev" / "torch_time_rungs.py",
             REPO / "dev" / "torch_fma_variant.py", REPO / "dev" / "torch_copy_probe.py",
             REPO / "dev" / "torch_call_time.py", REPO / "dev" / "torch_surface_scaling.py"]
    assert len(files) > 20
    for path in files:
        for name in _imported_modules(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "tsim_tpu"), f"{path.relative_to(REPO)} imports {name}"
