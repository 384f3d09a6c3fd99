"""The sampler's pipelined batch loop against a serial loop, on the CPU.

``sample()`` enqueues batch k + 1's noise draw and ladder before it moves
batch k's bits to the host (``sampler._RowsToHost``), draws exactly the shots
a last batch needs, and keeps postselection's prefilter, survivor pool and
scatter on the device. Here its output must equal, bit for bit, a serial
loop written out over ``sample_program_with_deviation`` on the same seed and
batch sizes (noise, then ladder, batch by batch; postselection with a host
scatter of each evaluated survivor batch, as the sampler did before), on d3
distillation and 1-check cultivation, with a short last batch, with and
without postselection. The card's graphed loop (``sampler._StepGraph``: a
size's first batch eager, its second captured, later ones replayed) runs
here with the graph run eagerly, against the eager loop; the step rule's
cases are in ``tests/test_torch_sampler.py``. On the card (``cuda``-marked)
a graphed ``sample()`` must equal the eager ``_sample_batch`` steps bit for
bit, and a checkpoint after graphed batches resume the stream.
"""

import numpy as np
import pytest
import torch

from tsim_tpu_torch import sampler as port_sampler
from tsim_tpu_torch.models.exported import cultivation_d3, distillation_d3

PROGRAMS = {"d3": distillation_d3(p=0.05), "cultivation1": cultivation_d3(p=0.001, checks=1)}


def _serial(sampler, seed: int, shots: int, batch: int) -> np.ndarray:
    generator = torch.Generator().manual_seed(seed)
    outs = []
    for start in range(0, shots, batch):
        f = sampler._device_channels.sample(generator, min(batch, shots - start))
        out, _ = port_sampler.sample_program_with_deviation(sampler._tables, f, generator)
        outs.append(out.numpy())
    return np.concatenate(outs).astype(np.bool_)


def _serial_postselected(sampler, seed: int, shots: int, batch: int, mask: np.ndarray) -> np.ndarray:
    """Chunks of ``batch`` shots; their survivors pooled in order and
    evaluated ``batch`` at a time (the rest at the end); discarded rows keep
    their direct detector columns only."""
    generator = torch.Generator().manual_seed(seed)
    tables, nd = sampler._tables, sampler._num_detectors
    post = torch.from_numpy(mask & sampler._direct_detector_mask)
    result = np.zeros((shots, sampler._program.num_outputs), np.bool_)
    pool_f = torch.zeros((0, sampler._device_channels.num_f), dtype=torch.uint8)
    pool_rows = np.zeros(0, np.int64)
    taken = 0
    while taken < shots:
        want = min(batch, shots - taken)
        f = sampler._device_channels.sample(generator, want)
        direct = tables.direct_outputs(f)[:, :nd]
        keep = ~(direct.bool() & post).any(dim=1)
        result[taken : taken + want, :nd] = direct.numpy()
        pool_f = torch.cat([pool_f, f[keep]])
        pool_rows = np.concatenate([pool_rows, np.flatnonzero(keep.numpy()) + taken])
        taken += want
        while len(pool_rows) >= batch or (taken == shots and len(pool_rows)):
            n = min(batch, len(pool_rows))
            out, _ = port_sampler.sample_program_with_deviation(tables, pool_f[:n], generator)
            result[pool_rows[:n]] = out.numpy()
            pool_f, pool_rows = pool_f[n:], pool_rows[n:]
    return result


@pytest.mark.parametrize("shots,batch", [(600, 256), (300, 64), (100, 256)])
@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_pipelined_sample_equals_serial_loop(program, shots, batch):
    sampler = PROGRAMS[program].compile_detector_sampler(seed=11, device="cpu")
    got = sampler.sample(shots, batch_size=batch, append_observables=True)
    assert got.dtype == np.bool_ and got.shape == (shots, sampler._program.num_outputs)
    np.testing.assert_array_equal(got, _serial(sampler, 11, shots, batch))


@pytest.mark.parametrize("shots,batch", [(600, 256), (300, 64)])
@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_pipelined_postselection_equals_serial_loop(program, shots, batch):
    sampler = PROGRAMS[program].compile_detector_sampler(seed=12, device="cpu")
    mask = np.ones(sampler._num_detectors, bool)
    assert sampler._coerce_postselection_mask(mask) is not None  # the prefilter acts
    got = sampler.sample(shots, batch_size=batch, postselection_mask=mask, append_observables=True)
    want = _serial_postselected(sampler, 12, shots, batch, mask)
    discarded = (want[:, : sampler._num_detectors] & sampler._direct_detector_mask).any(axis=1)
    assert discarded.any() or program == "cultivation1"
    np.testing.assert_array_equal(got, want)


def test_survivor_batches_span_chunks(monkeypatch):
    """d3 with every detector postselected keeps about 58% of the shots:
    survivors of several chunks share an evaluated batch, and a chunk waits
    on the device until its last survivor is evaluated."""
    sampler = PROGRAMS["d3"].compile_detector_sampler(seed=13, device="cpu")
    batches = []
    orig = port_sampler.sample_program_with_deviation

    def spy(tables, f_params, generator, uniforms=None):
        batches.append(f_params.shape[0])
        return orig(tables, f_params, generator, uniforms)

    monkeypatch.setattr(port_sampler, "sample_program_with_deviation", spy)
    mask = np.ones(sampler._num_detectors, bool)
    got = sampler.sample(1000, batch_size=100, postselection_mask=mask, append_observables=True)
    survivors = int((~(got[:, :15] & sampler._direct_detector_mask).any(axis=1)).sum())
    assert batches[:-1] == [100] * (len(batches) - 1) and sum(batches) == survivors
    assert len(batches) < 10  # fewer evaluations than chunks


def test_kept_rows_without_a_host_read():
    keep = torch.from_numpy(np.random.default_rng(0).random(1000) < 0.3)
    n = int(keep.sum())
    np.testing.assert_array_equal(port_sampler._kept_rows(keep, n).numpy(), np.flatnonzero(keep.numpy()))
    assert port_sampler._kept_rows(torch.zeros(5, dtype=torch.bool), 0).shape == (0,)


def test_rows_to_host_on_the_cpu_moves_at_once():
    result = np.zeros((5, 3), np.bool_)
    to_host = port_sampler._RowsToHost(result, torch.device("cpu"), 4)
    bits = torch.tensor([[1, 0, 1], [0, 1, 1]], dtype=torch.uint8)
    to_host.push(bits, 2)
    np.testing.assert_array_equal(result[2:4], bits.numpy().astype(bool))
    assert not result[[0, 1, 4]].any()
    to_host.close()


@pytest.mark.cuda
def test_pipelined_sample_on_the_card_equals_serial_loop():
    """The same on the card, where the copies go through pinned staging
    buffers on a stream of their own."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sampler = PROGRAMS["d3"].compile_detector_sampler(seed=14, device="cuda")
    got = sampler.sample(5000, batch_size=2048, append_observables=True)
    generator = torch.Generator(device="cuda").manual_seed(14)
    outs = []
    for start in range(0, 5000, 2048):
        f = sampler._device_channels.sample(generator, min(2048, 5000 - start))
        outs.append(port_sampler.sample_program_with_deviation(sampler._tables, f, generator)[0].cpu().numpy())
    np.testing.assert_array_equal(got, np.concatenate(outs).astype(bool))


@pytest.mark.cuda
def test_pipelined_sample_on_an_explicit_device_equals_serial_loop():
    """A sampler on an explicit ``cuda:N``, the last card, sampled while the
    current device is card 0: each copy must wait on the ladder of the
    sampler's device, not on the current device's stream (with one card the
    two are the same and the case still runs on ``cuda:0``). Batches of
    2^18 shots keep the ladder busy long enough for a copy that does not
    wait to read unfinished rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    device = f"cuda:{torch.cuda.device_count() - 1}"
    shots, batch = 4 << 18, 1 << 18
    with torch.cuda.device(0):
        sampler = PROGRAMS["d3"].compile_detector_sampler(seed=15, device=device)
        got = sampler.sample(shots, batch_size=batch, append_observables=True)
    generator = torch.Generator(device=device).manual_seed(15)
    outs = []
    for start in range(0, shots, batch):
        f = sampler._device_channels.sample(generator, batch)
        outs.append(port_sampler.sample_program_with_deviation(sampler._tables, f, generator)[0].cpu().numpy())
    np.testing.assert_array_equal(got, np.concatenate(outs).astype(bool))


class _EagerStepGraph(port_sampler._StepGraph):
    """The captured step as the CPU can run it: "capturing" keeps the step,
    and each replay runs it eagerly into static outputs, which it rewrites
    as a replay does. The loop's bookkeeping around a graph (the running
    deviation, the fresh copy or fold of the static bits) is then the
    card's."""

    def __init__(self, sampler, shard, rows):
        self.rows, self._sampler, self._shard = rows, sampler, shard
        n_out = shard.tables.num_outputs
        self.out = torch.empty((rows, n_out), dtype=torch.uint8)
        self.dev = torch.empty((1,), dtype=torch.float32)

    def replay(self):
        out, dev = self._sampler._sample_batch(self.rows, shard=self._shard)
        self.out.copy_(out)
        self.dev.copy_(dev)
        return self.out, self.dev


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("mesh", [None, 2])
def test_graphed_loop_equals_eager_loop(mesh, fold, monkeypatch):
    """With every shard taking the graphed path (the graph run eagerly),
    two calls equal the eager loop's two calls on the same seed bit for
    bit, deviation included: a size's first batch is eager, its second
    captured, later ones replayed, and a shorter last batch eager; the
    second call replays from its first batch."""
    kwargs = {"device": "cpu"} if mesh is None else {"mesh": port_sampler.ShotMesh(["cpu"] * mesh)}
    options = {"use_detector_reference_sample": fold, "append_observables": True}
    shots, batch = 5 * 64 + 17, 64
    plain = PROGRAMS["d3"].compile_detector_sampler(seed=16, **kwargs)
    wants = [(plain.sample(shots, batch_size=batch, **options), plain.last_norm_deviation) for _ in range(2)]
    assert plain.last_batch_steps == {"eager": 6 * len(plain._shards), "capture": 0, "replay": 0}
    monkeypatch.setattr(port_sampler, "_graphs_on", lambda device: True)
    monkeypatch.setattr(port_sampler, "_StepGraph", _EagerStepGraph)
    sampler = PROGRAMS["d3"].compile_detector_sampler(seed=16, **kwargs)
    shards = len(sampler._shards)
    steps = [{"eager": 2, "capture": 1, "replay": 4}, {"eager": 1, "capture": 0, "replay": 5}]
    for (want, want_dev), want_steps in zip(wants, steps):
        np.testing.assert_array_equal(sampler.sample(shots, batch_size=batch, **options), want)
        assert sampler.last_norm_deviation == want_dev
        assert sampler.last_batch_steps == {k: v * shards for k, v in want_steps.items()}
    assert all(s.graph is not None and s.graph.rows == batch // shards for s in sampler._shards)
    sampler._drop_graphs()
    assert all(s.graph is None and s.warm_rows == 0 for s in sampler._shards)


def test_auto_mesh_keeps_one_call_of_graphs_a_device(monkeypatch):
    """Under mesh="auto" a small call runs on the unsharded shard and a
    large one on the mesh's first shards, all on one device here as the
    first two are on card 0: calls of alternating sizes (the graph run
    eagerly) leave on the device only the graphs of the last call's shards,
    and their samples equal an eager auto sampler's on the same seed."""
    monkeypatch.setattr(port_sampler, "_auto_mesh", lambda: port_sampler.ShotMesh(["cpu"] * 4))
    monkeypatch.setattr(port_sampler, "AUTO_MIN_ROWS_PER_CARD", 64)
    monkeypatch.setattr(port_sampler, "AUTO_FLOOR_ROWS_PER_CARD", 1)
    monkeypatch.setattr(port_sampler._CompiledSamplerBase, "_seconds_per_row",
                        lambda self: port_sampler.AUTO_REFERENCE_SECONDS_PER_ROW)
    calls = [(32, 1), (128, 2), (32, 1), (128, 2)]  # (batch, shards the batch takes)
    plain = PROGRAMS["d3"].compile_detector_sampler(seed=20)
    wants = [plain.sample(3 * batch, batch_size=batch) for batch, _ in calls]
    monkeypatch.setattr(port_sampler, "_graphs_on", lambda device: True)
    monkeypatch.setattr(port_sampler, "_StepGraph", _EagerStepGraph)
    auto = PROGRAMS["d3"].compile_detector_sampler(seed=20)
    assert auto._mesh_spec == "auto" and auto._mesh.size == 4
    for (batch, k), want in zip(calls, wants):
        np.testing.assert_array_equal(auto.sample(3 * batch, batch_size=batch), want)
        held = [s for s in auto._every_shard() if s.graph is not None]
        busy = auto._shards_for(batch)
        assert len(busy) == k and len(held) == k and all(any(s is b for b in busy) for s in held)
        assert auto.last_batch_steps["capture"] == k  # each call captures again what the other dropped


def test_cpu_sampler_never_captures():
    sampler = PROGRAMS["d3"].compile_detector_sampler(seed=17, device="cpu")
    for _ in range(2):
        sampler.sample(300, batch_size=64)
        assert sampler.last_batch_steps == {"eager": 5, "capture": 0, "replay": 0}
    assert sampler._solo.graph is None and sampler._solo.warm_rows == 0


@pytest.mark.cuda
@pytest.mark.parametrize("program,evaluation", [("d3", "f32"), ("cultivation1", "f32"), ("d3", "exact")])
def test_graphed_sample_on_the_card_equals_eager_steps(program, evaluation):
    """On the card: a graphed ``sample()`` of several batches (one eager,
    one captured, replays, a shorter last batch) equals the eager
    ``_sample_batch`` steps on a generator of the same seed, bit for bit,
    deviation included; a second call replays from its first batch; the
    noise-draw kernel ran, and a save after graphed batches resumes the
    same stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tsim_tpu_torch.kernels import noise_draw

    sampler = PROGRAMS[program].compile_detector_sampler(seed=18, device="cuda", evaluation=evaluation)
    shots, batch = 5 * 4096 + 100, 4096
    state = sampler._generator.get_state()
    noise_draw.reset_launch_counts()
    got = sampler.sample(shots, batch_size=batch, append_observables=True)
    assert sampler.last_batch_steps == {"eager": 2, "capture": 1, "replay": 4}
    assert noise_draw.launch_counts["noise_draw"] == 6  # a replay counts what it launches
    graphed_dev = sampler.last_norm_deviation
    sampler._generator.set_state(state)
    outs, devs = [], []
    for start in range(0, shots, batch):
        out, dev = sampler._sample_batch(min(batch, shots - start))
        outs.append(out.cpu().numpy())
        devs.append(float(dev[0]))
    np.testing.assert_array_equal(got, np.concatenate(outs).astype(bool))
    assert graphed_dev == max(devs)
    again = sampler.sample(2 * batch, batch_size=batch)
    assert sampler.last_batch_steps == {"eager": 0, "capture": 0, "replay": 2} and again.shape[0] == 2 * batch


@pytest.mark.cuda
def test_checkpoint_after_graphed_batches_resumes_the_stream(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sampler = PROGRAMS["d3"].compile_detector_sampler(seed=19, device="cuda")
    sampler.sample(3 * 4096, batch_size=4096)
    assert sampler.last_batch_steps["replay"] == 2
    sampler.save(tmp_path / "s.npz")
    loaded = type(sampler).load(tmp_path / "s.npz")
    np.testing.assert_array_equal(sampler.sample(2 * 4096, batch_size=4096), loaded.sample(2 * 4096, batch_size=4096))


@pytest.mark.cuda
def test_graphed_sharded_sample_on_the_cards_equals_eager_steps():
    """A mesh of every card (two replicas of card 0 on a one-card host):
    each shard captures its own step on its own card; the graphed call
    equals every shard's eager steps from the same generator states."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tsim_tpu_torch.parallel.shard import ShotMesh, shard_sizes

    n = torch.cuda.device_count()
    mesh = ShotMesh([f"cuda:{i}" for i in range(n)] if n > 1 else ["cuda:0"] * 2)
    sampler = PROGRAMS["d3"].compile_detector_sampler(seed=20, mesh=mesh)
    batch = 1 << 14
    sampler.sample(2 * batch, batch_size=batch)  # warm-up and capture
    states = [s.generator.get_state() for s in sampler._shards]
    got = sampler.sample(3 * batch, batch_size=batch, append_observables=True)
    assert sampler.last_batch_steps == {"eager": 0, "capture": 0, "replay": 3 * mesh.size}
    assert {str(s.graph.out.device) for s in sampler._shards} == {str(d) for d in mesh.distinct}
    for s, state in zip(sampler._shards, states):
        s.generator.set_state(state)
    outs = []
    for _ in range(3):
        for s, rows in zip(sampler._shards, shard_sizes(batch, mesh.size)):
            outs.append(sampler._sample_batch(rows, shard=s)[0].cpu().numpy())
    np.testing.assert_array_equal(got, np.concatenate(outs).astype(bool))
