"""The port's sampler against tsim_tpu's, bit for bit on injected randomness.

JAX's threefry and torch's generators give different streams, so the
test replays tsim_tpu's key schedule for one batch
(``dev/export_torch_program.py::jax_replay``) and gives the port the same
uniforms. tsim_tpu on the CPU evaluates exactly. In f32 mode a draw may
differ only where the uniform lies within 1e-4 of the probability, and
such rows must be rare; in exact mode every bit must be equal.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import tsim_tpu
from dev.export_torch_program import compile_cultivation, compile_d3, export_sampler, jax_replay
from tsim_tpu_torch import sampler as port_sampler
from tsim_tpu_torch.compile import exact_eval, sample_eval
from tsim_tpu_torch.compile.exact_tables import ExactTables
from tsim_tpu_torch.compile.sample_eval import evaluate_abs_sample, synthetic_rung
from tsim_tpu_torch.compile.sample_tables import SampleTables
from tsim_tpu_torch.kernels import exact_eval as exact_kernel
from tsim_tpu_torch.models.exported import cultivation_d3, distillation_d3, distillation_d5
from tsim_tpu_torch.noise.device_channels import DeviceChannelSampler, read_draw_table
from tsim_tpu_torch.ops.gf2 import static_take_columns

BORDER = 1e-4


def _borderline_rows(tables, f, draws):
    """Rows where some rung's uniform lies within BORDER of the port's probability."""
    near = torch.zeros(f.shape[0], dtype=torch.bool)
    it = iter(draws)
    for comp in tables.components:
        comp_draws = [next(it) for _ in comp.rungs[1:]]
        bits, _ = port_sampler._sample_component(comp, f, None, iter(comp_draws))
        noise_bits = static_take_columns(f, comp.f_selection)
        mass = evaluate_abs_sample(comp.rungs[0], noise_bits)
        for k, rung in enumerate(comp.rungs[1:]):
            x = torch.cat([noise_bits, bits[:, :k], torch.ones_like(bits[:, :1])], dim=1)
            p_one = evaluate_abs_sample(rung, x)
            p = torch.clamp(p_one / mass, 0.0, 1.0)
            near |= (comp_draws[k] - p).abs() < BORDER
            mass = torch.where(bits[:, k].bool(), p_one, mass - p_one)
    return near.numpy()


def _port_replay(exported, u_noise, draws, evaluation="f32"):
    """The port's bits and norm deviation on tsim_tpu's uniforms."""
    tables = port_sampler.ProgramTables(exported.program, evaluation)
    noise = DeviceChannelSampler(exported.noise, "cpu")
    f = noise.sample_from_uniforms(torch.from_numpy(np.array(u_noise)))
    draws_t = [torch.from_numpy(np.array(d)) for d in draws]
    got, dev = port_sampler.sample_program_with_deviation(tables, f, None, uniforms=draws_t)
    return got.numpy(), float(dev[0]), tables, f, draws_t


def _compare_with_jax(sampler, batch, seed):
    u_noise, draws, want, jax_dev = jax_replay(sampler, batch, seed)
    got, dev, tables, f, draws_t = _port_replay(export_sampler(sampler), u_noise, draws)
    assert got.shape == want.shape and got.dtype == np.uint8
    mismatched = (got != want).any(axis=1)
    near = _borderline_rows(tables, f, draws_t)
    assert not (mismatched & ~near).any(), np.flatnonzero(mismatched & ~near)
    return got, dev, jax_dev, near.mean()


def test_d3_slice_matches_tsim_tpu_bits():
    got, dev, jax_dev, near_share = _compare_with_jax(compile_d3(), batch=4096, seed=0)
    assert got.shape == (4096, 20)
    assert near_share < 1e-3
    assert dev <= 3e-3 and jax_dev <= 1e-5


@pytest.mark.parametrize(
    "text",
    [
        "H 0\nT 0\nX_ERROR(0.2) 0\nH 0\nM 0\nH 1\nT 1\nH 1\nM 1",
        "H 0\nS 0\nT 0\nCX 0 1\nT 1\nY_ERROR(0.1) 0\nH 0\nM 0 1",
    ],
)
def test_measurement_programs_match_tsim_tpu_bits(text):
    sampler = tsim_tpu.Circuit(text).compile_sampler(seed=0)
    _, _, _, near_share = _compare_with_jax(sampler, batch=2048, seed=5)
    assert near_share < 1e-3


def test_measurement_sampler_runs():
    sampler = tsim_tpu.Circuit("H 0\nT 0\nX_ERROR(0.2) 0\nH 0\nM 0\nH 1\nT 1\nH 1\nM 1")
    exported = export_sampler(sampler.compile_sampler(seed=0))
    port = port_sampler.CompiledMeasurementSampler(exported, seed=1, device="cpu")
    out = port.sample(1000, batch_size=300)
    assert out.shape == (1000, 2) and out.dtype == np.bool_
    assert port.sample(0).shape == (0, 2)


@pytest.fixture(scope="module")
def d3():
    return distillation_d3(p=0.05)


def test_seeded_determinism(d3):
    a = d3.compile_detector_sampler(seed=3, device="cpu").sample(600, batch_size=256)
    b = d3.compile_detector_sampler(seed=3, device="cpu").sample(600, batch_size=256)
    c = d3.compile_detector_sampler(seed=4, device="cpu").sample(600, batch_size=256)
    assert a.shape == (600, 15)
    np.testing.assert_array_equal(a, b)
    assert (a != c).any()


def test_observable_layouts(d3):
    full = d3.compile_detector_sampler(seed=1, device="cpu").sample(
        300, batch_size=128, append_observables=True
    )
    assert full.shape == (300, 20)
    det, obs = full[:, :15], full[:, 15:]

    def again(**kw):
        return d3.compile_detector_sampler(seed=1, device="cpu").sample(300, batch_size=128, **kw)

    np.testing.assert_array_equal(again(), det)
    np.testing.assert_array_equal(again(prepend_observables=True), np.hstack([obs, det]))
    d, o = again(separate_observables=True)
    np.testing.assert_array_equal(d, det)
    np.testing.assert_array_equal(o, obs)
    np.testing.assert_array_equal(
        again(append_observables=True, bit_packed=True),
        np.packbits(full, axis=1, bitorder="little"),
    )


def test_unported_options_raise(d3, tmp_path):
    """Postselection and reference samples are ported (test_torch_postselection.py),
    and so are checkpointing (test_torch_checkpoint.py) and fully-direct
    programs (test_torch_direct_sampling.py); other committed circuits raise."""
    s = d3.compile_detector_sampler(seed=0, device="cpu")
    assert s.sample(10, postselection_mask=np.ones(15, bool)).shape == (10, 15)
    assert s.sample(10, use_detector_reference_sample=True).shape == (10, 15)
    s.save(tmp_path / "sampler.ckpt")
    restored = port_sampler.CompiledDetectorSampler.load(tmp_path / "sampler.ckpt")
    np.testing.assert_array_equal(restored.sample(10), s.sample(10))
    with pytest.raises(ValueError, match="mutually exclusive"):
        s.sample(10, separate_observables=True, append_observables=True)
    with pytest.raises(NotImplementedError, match="distillation_d3"):
        distillation_d3(p=0.01)
    with pytest.raises(NotImplementedError, match="cultivation_d3"):
        cultivation_d3(p=0.001, checks=3)


def test_fully_direct_program_raises():
    """An exported fully-direct program samples on the host from its noise
    model (tsim_tpu's bits at the same seed); a noise model whose channels
    do not fit its signature matrix raises, asking for a Circuit."""
    sampler = tsim_tpu.Circuit("X_ERROR(0.1) 0\nM 0\nDETECTOR rec[-1]").compile_detector_sampler(seed=0)
    exported = export_sampler(sampler)
    assert not exported.program.components
    port = port_sampler.CompiledDetectorSampler(exported, seed=0, device="cpu")
    np.testing.assert_array_equal(port.sample(1000), sampler.sample(1000))
    bad = dataclasses.replace(
        exported.noise, signature_matrix=np.zeros((0, exported.noise.signature_matrix.shape[1]), np.uint8)
    )
    with pytest.raises(ValueError, match="from a Circuit"):
        port_sampler.CompiledDetectorSampler(
            dataclasses.replace(exported, noise=bad), seed=0, device="cpu"
        )


def test_norm_deviation_check():
    port_sampler._check_norm_deviation(torch.tensor([1e-4]))
    with pytest.raises(ValueError, match="vanishing"):
        port_sampler._check_norm_deviation(torch.tensor([1.0]))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        port_sampler._check_norm_deviation(torch.tensor([1e-2]))
    assert any("not normalized" in str(w.message) for w in caught)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        port_sampler._check_norm_deviation(torch.tensor([1e-4]), "exact")
    assert any("not normalized" in str(w.message) for w in caught)


def test_default_batch_size_on_cpu(d3):
    s = d3.compile_detector_sampler(seed=0, device="cpu")
    assert s._estimate_batch_size() == min(s._card_rows(), port_sampler.DEFAULT_ROWS_PER_CARD) >= 1
    assert s.sample(100).shape == (100, 15)


# ------------------------------------------------- the batch's memory model

COMMITTED = {
    "d3": lambda: distillation_d3(p=0.05),
    "d5": lambda: distillation_d5(p=0.02),
    "checks1": lambda: cultivation_d3(p=0.001, checks=1),
    "checks2": lambda: cultivation_d3(p=0.001, checks=2),
}
CARD = torch.device("cuda:0")
FREE_80GB = 79 * 10**9  # free bytes of an idle 80 GB card


def _xla_model_bytes(program, noise_peak: int, num_f: int) -> int:
    """tsim_tpu's model of a row (``tsim_tpu/sampler.py:777-791``), which
    the port used before: the (B, G, T) intermediate XLA materialises."""
    peak = max(8 * num_f, noise_peak)
    for comp in program.components:
        for c in comp.compiled_scalar_graphs:
            largest = max(np.shape(c.node_phases.phases)[0] * 16, np.shape(c.halfpi_phases.coeffs)[0] * 4,
                          np.shape(c.pi_products.psi_const)[0] * 4, np.shape(c.phase_pairs.alpha)[0] * 16)
            peak = max(peak, c.num_graphs * largest * 3)
    return peak


@pytest.mark.parametrize("evaluation", ["f32", "exact"])
@pytest.mark.parametrize("program", sorted(COMMITTED))
def test_default_batch_on_an_80_gb_card_is_the_ceiling(program, evaluation, monkeypatch):
    """The sampler as if on a card with 79 GB free: one batch of
    DEFAULT_ROWS_PER_CARD rows by default, plain or postselected, where the
    XLA model gave 178,700 rows (2-check cultivation) to 3,994,741 (d3)."""
    s = COMMITTED[program]().compile_detector_sampler(seed=0, device="cpu", evaluation=evaluation)
    s._shards = [dataclasses.replace(s._solo, device=CARD)]
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device: (FREE_80GB, 80 * 10**9))
    ceiling = port_sampler.DEFAULT_ROWS_PER_CARD
    assert s._card_rows() >= s._card_rows(postselected=True) > ceiling
    assert s._estimate_batch_size() == s._estimate_batch_size(postselected=True) == ceiling
    assert s._plan_batches(8 * ceiling, None) == (ceiling, s._shards)
    assert s._plan_batches(8 * ceiling, None, postselected=True)[0] == ceiling
    old = (FREE_80GB // 2) // _xla_model_bytes(s._program, 16 * s._device_channels.num_channels,
                                                s._device_channels.num_f)
    assert old != ceiling


def _peak_bytes(fn) -> int:
    """The most bytes the CPU allocator held at once while ``fn()`` ran, above
    what it held before: the profiler's allocation events (a free is one of
    negative size) summed in time order. On one thread: the profiler is
    slow to trace the CPU's parallel kernels, and the bytes do not change."""
    from torch._C._profiler import _EventType
    from torch.profiler import ProfilerActivity, profile

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
            fn()
    finally:
        torch.set_num_threads(threads)
    nodes, events = list(prof.profiler.kineto_results.experimental_event_tree()), []
    while nodes:
        node = nodes.pop()
        nodes.extend(node.children)
        if node.tag == _EventType.Allocation:
            events.append((node.start_time_ns, node.extra_fields.alloc_size))
    live = peak = 0
    for _, size in sorted(events, key=lambda e: e[0]):
        live += size
        peak = max(peak, live)
    return peak


def _card_glue(tables, x):
    """``evaluate_abs_sample`` as a card runs it, on the CPU: the kernels'
    outputs (zeros of their shapes, ``kernels/``) through the dispatch's
    own code after them."""
    rows = x.shape[0]
    if tables.num_graphs == 0:
        return torch.zeros(rows)
    if isinstance(tables, ExactTables):
        n = exact_kernel.num_tiles(tables.num_graphs)
        if tables.approximate:
            return exact_eval.approx_magnitude(torch.zeros((n, rows, 2)))
        return exact_eval.combine_partials(torch.zeros((n, rows, 4), dtype=torch.int32),
                                           torch.zeros((n, rows), dtype=torch.int32))
    return sample_eval._magnitude(torch.zeros((rows, 2)), tables.bias)


def _card_noise(channels, u):
    """``DeviceChannelSampler.from_uniforms`` as a card runs it, on the CPU:
    the kernel's (B, num_f) uint8 output, filled in place by the plain
    reader of its table (numpy, which the allocation events do not see; a
    torch ``copy_`` would add a temporary of its own that the kernel does
    not make)."""
    out = torch.empty((u.shape[0], channels.num_f), dtype=torch.uint8)
    out.numpy()[:] = read_draw_table(channels.table, channels.num_channels, channels.num_f, u.numpy())
    return out


MODEL_ROWS = 2048
CALL_BYTES = 256  # a call's scalar temporaries, the same at any number of rows


@pytest.mark.parametrize("device", ["cpu", "card"])
@pytest.mark.parametrize("evaluation", ["f32", "exact"])
@pytest.mark.parametrize("program", ["d3", "checks1"])
def test_modelled_bytes_bound_a_seeded_batch(program, evaluation, device, monkeypatch):
    """What a pipelined call of two batches and a postselected call of two
    chunks allocate on the CPU is at most the model's bytes a row times the
    rows: with the plain versions against the CPU's count, and with the
    kernels' outputs and the dispatch's code after them against a card's."""
    s = COMMITTED[program]().compile_detector_sampler(seed=3, device="cpu", evaluation=evaluation)
    if device == "card":
        monkeypatch.setattr(port_sampler, "evaluate_abs_sample", _card_glue)
        monkeypatch.setattr(DeviceChannelSampler, "from_uniforms", _card_noise)
    model = s._peak_bytes_per_sample(torch.device("cpu") if device == "cpu" else CARD)
    post = s._peak_bytes_per_sample(torch.device("cpu") if device == "cpu" else CARD, postselected=True)
    mask = np.ones(s._num_detectors, bool)
    B = MODEL_ROWS
    loop = _peak_bytes(lambda: s.sample(2 * B, batch_size=B, use_detector_reference_sample=True))
    postselected = _peak_bytes(lambda: s.sample(2 * B, batch_size=B, postselection_mask=mask))
    assert loop <= model * B
    assert postselected <= post * B
    # The count is no loose bound: the measured peak is most of it.
    assert loop > model * B / 2


EVALUATED_RUNGS = [(1, 5, (0, 0, 0, 0)), (3, 9, (1, 0, 0, 0)), (40, 12, (0, 6, 0, 0)), (40, 12, (0, 0, 6, 0)),
                   (40, 12, (0, 0, 0, 6)), (40, 12, (7, 0, 0, 0)), (100, 30, (3, 3, 3, 3)),
                   (200, 20, (1, 9, 1, 1)), (50, 70, (10, 2, 2, 5)), (300, 16, (2, 2, 12, 1))]


@pytest.mark.parametrize("graphs,params,terms", EVALUATED_RUNGS)
def test_evaluator_counts_bound_what_each_allocates(graphs, params, terms):
    """Each evaluator's bytes a row bound what it allocates for a seeded
    rung: the f32 and exact plain versions (the CPU's count), and on a
    card the kernels' outputs with the dispatch's code after them (exact:
    with and without approximate floatfactors)."""
    rung = synthetic_rung(graphs, graphs, params, terms)
    x = torch.from_numpy(np.random.default_rng(graphs).integers(0, 2, (MODEL_ROWS, params), dtype=np.uint8))
    cpu = torch.device("cpu")
    f32 = SampleTables(rung)
    exact = ExactTables(rung)
    approx = ExactTables(dataclasses.replace(rung, prefactor=dataclasses.replace(
        rung.prefactor, has_approximate_floatfactors=True)))
    assert approx.approximate and not exact.approximate
    for tables in (f32, approx, exact):
        got = _peak_bytes(lambda: evaluate_abs_sample(tables, x))
        assert got <= sample_eval.bytes_per_row(tables, cpu) * MODEL_ROWS + CALL_BYTES
        got = _peak_bytes(lambda: _card_glue(tables, x))
        assert got <= sample_eval.bytes_per_row(tables, CARD) * MODEL_ROWS + CALL_BYTES


@pytest.mark.parametrize("program", sorted(COMMITTED))
def test_noise_draw_count_bounds_what_it_allocates(program):
    """The noise draw's bytes a shot bound what ``sample`` allocates, packed
    (d3, 1-check) and by bitplanes (d5, 2-check), and are most of it."""
    s = COMMITTED[program]().compile_detector_sampler(seed=0, device="cpu")
    channels = s._device_channels
    assert channels.packed == (program in ("d3", "checks1"))
    got = _peak_bytes(lambda: channels.sample(s._generator, MODEL_ROWS))
    count = channels.peak_bytes_per_shot(torch.device("cpu"))
    assert 0.9 * count * MODEL_ROWS < got <= count * MODEL_ROWS


@pytest.fixture(scope="module")
def cultivation_sampler():
    return compile_cultivation()


def test_d3_exact_mode_matches_tsim_tpu_bits():
    """Exact mode: every one of 4096 shots equal to tsim_tpu's, no borderline exemption."""
    sampler = compile_d3()
    u_noise, draws, want, jax_dev = jax_replay(sampler, 4096, 0)
    got, dev, *_ = _port_replay(export_sampler(sampler), u_noise, draws, "exact")
    np.testing.assert_array_equal(got, want)
    assert dev <= 1e-5 and jax_dev <= 1e-5


def test_cultivation_exact_mode_matches_tsim_tpu_bits(cultivation_sampler):
    u_noise, draws, want, jax_dev = jax_replay(cultivation_sampler, 512, 3)
    exported = export_sampler(cultivation_sampler)
    got, dev, *_ = _port_replay(exported, u_noise, draws, "exact")
    assert got.shape == (512, 12)
    np.testing.assert_array_equal(got, want)
    assert dev <= 1e-5 and jax_dev <= 1e-5


def test_committed_cultivation_replay_matches():
    """The committed replay of tsim_tpu's exact sampling, reproduced bit for
    bit on the CPU on its first 1024 shots (each shot depends only on its own
    uniforms; chip_smoke.py checks all 4096 on the card)."""
    exported = cultivation_d3(checks=2).load()
    r = exported.replay
    rows = 1024
    got, dev, *_ = _port_replay(
        exported, r["noise_uniforms"][:rows], [d[:rows] for d in r["draw_uniforms"]], "exact"
    )
    np.testing.assert_array_equal(got, r["bits"][:rows])
    assert dev <= 1e-5


def test_exact_mode_sampler_runs(d3):
    s = d3.compile_detector_sampler(seed=2, device="cpu", evaluation="exact")
    out = s.sample(700, batch_size=256, append_observables=True)
    assert out.shape == (700, 20) and out.dtype == np.bool_
    assert s.last_norm_deviation <= port_sampler.norm_deviation_tolerance("exact") == 1e-5
    assert all(
        type(rung).__name__ == "ExactTables" for comp in s._tables.components for rung in comp.rungs
    )
    with pytest.raises(ValueError, match="evaluation"):
        d3.compile_detector_sampler(seed=0, device="cpu", evaluation="f64")


@pytest.mark.parametrize("warm,graph,rows,action", [
    (0, None, 64, "eager"),       # a size's first batch warms it up
    (64, None, 64, "capture"),    # its second is captured
    (64, 64, 64, "replay"),       # later ones replay
    (32, 64, 64, "replay"),       # another size warmed up since keeps the graph until captured
    (64, 32, 64, "capture"),      # the new size replaces the graph of the old one
    (64, 64, 32, "eager"),        # another size warms up without touching the graph
    (32, 64, 32, "capture"),
])
def test_step_action_keys_on_rows_and_keeps_one_size(warm, graph, rows, action):
    assert port_sampler._step_action(warm, graph, rows) == action


@pytest.mark.parametrize("program", ["d3", "checks1"])
def test_card_model_counts_the_kernel_draw(program):
    """On a card a plain batch holds the noise kernel's uniforms and output
    (4C + num_f) or the ladder, whichever is more, beside the previous
    batch's waiting outputs and their fold (a replay's bits pushed as a
    fresh copy, as an eager batch's)."""
    s = COMMITTED[program]().compile_detector_sampler(seed=0, device="cpu")
    n_out, ch = s._program.num_outputs, s._device_channels
    ladder = port_sampler._ladder_bytes_per_row(s._tables, ch.num_f, CARD)
    want = 2 * n_out + max(4 * ch.num_channels + ch.num_f, ladder)
    assert s._peak_bytes_per_sample(CARD) == want
    cpu = torch.device("cpu")
    assert s._peak_bytes_per_sample(cpu) == 2 * n_out + max(
        ch.peak_bytes_per_shot(cpu), port_sampler._ladder_bytes_per_row(s._tables, ch.num_f, cpu))
