"""Shot-sharded sampling in the port (``tsim_tpu_torch/parallel/shard.py``
and the samplers' ``mesh=``), on meshes of CPU replicas.

Mirrors ``tests/unit/test_sharded_sampler.py`` (same circuit, same bounds),
holds the sharded step to ``tsim_tpu``'s bits on injected uniforms and the
sharded samplers to ``tsim_tpu``'s own sharded sampler (the 8 virtual CPU
devices of ``tests/conftest.py``), and checks each shard bit for bit against
a serial loop on its own generator, plain and postselected. A replica is a
mesh entry that repeats a device: the CPU stands in for several cards.
JAX and ``tsim_tpu`` are imported inside the tests that compare with them,
so that the CUDA-marked cases also run where JAX is absent.
"""

from math import ceil

import numpy as np
import pytest
import torch

from dev.export_torch_program import compile_d3, export_sampler, jax_replay
from tests.test_torch_batch_loop import _serial, _serial_postselected
from tsim_tpu_torch import program_io
from tsim_tpu_torch import sampler as port_sampler
from tsim_tpu_torch.circuit import Circuit
from tsim_tpu_torch.compile import sample_eval
from tsim_tpu_torch.kernels import sample_eval as kernel
from tsim_tpu_torch.models.exported import distillation_d3
from tsim_tpu_torch.noise.device_channels import DeviceChannelSampler
from tsim_tpu_torch.parallel.shard import (
    ShotMesh,
    make_shot_mesh,
    shard_seed,
    shard_sizes,
    sharded_sample_program,
    sharded_sampler_step,
)
from tsim_tpu_torch.sampler import CompiledDetectorSampler

CIRCUIT = """
H 0
T 0
CNOT 0 1
X_ERROR(0.25) 0
DEPOLARIZE1(0.05) 1
M 0 1
DETECTOR rec[-1] rec[-2]
OBSERVABLE_INCLUDE(0) rec[-1]
"""

D3 = distillation_d3(p=0.05)


@pytest.fixture(scope="module")
def mesh():
    return ShotMesh(["cpu"] * 4)


def _z(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per-column z of two runs' means, with the pooled binomial sigma."""
    ma, mb = a.mean(axis=0, dtype=np.float64), b.mean(axis=0, dtype=np.float64)
    pooled = (ma * len(a) + mb * len(b)) / (len(a) + len(b))
    sigma = np.sqrt(np.maximum(pooled * (1 - pooled), 1e-12) * (1 / len(a) + 1 / len(b)))
    return np.abs(ma - mb) / sigma


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


# ------------------------------------------- mirrors of tsim_tpu's sharded tests


def test_sharded_detector_statistics(mesh):
    c = Circuit(CIRCUIT)
    sharded = c.compile_detector_sampler(seed=3, mesh=mesh)
    assert sharded._mesh is mesh and sharded.device == torch.device("cpu")
    det = sharded.sample(8000, batch_size=4000)
    base = c.compile_detector_sampler(seed=4, mesh=None, device="cpu").sample(8000, batch_size=4000)
    assert det.shape == base.shape
    # 4-sigma binomial agreement per column.
    for j in range(det.shape[1]):
        p = base[:, j].mean()
        sigma = np.sqrt(max(p * (1 - p), 1e-4) / 8000)
        assert abs(det[:, j].mean() - p) < 4 * sigma + 1e-3


def test_sharded_batch_not_dividing_the_mesh(mesh):
    # tsim_tpu rounds such a batch up; the port splits it unevenly. Either
    # way the result has exactly `shots` rows.
    s = Circuit(CIRCUIT).compile_detector_sampler(seed=5, mesh=mesh)
    det = s.sample(1001, batch_size=501)
    assert det.shape[0] == 1001


def test_sharded_deterministic(mesh):
    c = Circuit(CIRCUIT)
    a = c.compile_detector_sampler(seed=11, mesh=mesh).sample(512, batch_size=256)
    b = c.compile_detector_sampler(seed=11, mesh=mesh).sample(512, batch_size=256)
    assert np.array_equal(a, b)


def test_mesh_auto_is_none_on_cpu():
    c = Circuit(CIRCUIT)
    s = c.compile_detector_sampler(seed=0, device="cpu")
    assert s._mesh is None and s._mesh_spec is None
    if not torch.cuda.is_available():
        # "auto" never resolves to the CPU: without a device the sampler
        # needs a card.
        with pytest.raises(RuntimeError, match='device="cpu"'):
            c.compile_detector_sampler(seed=0)


def test_measurement_sampler_sharded(mesh):
    c = Circuit("H 0\nT 0\nX_ERROR(0.3) 0\nM 0")
    m = c.compile_sampler(seed=2, mesh=mesh).sample(4096, batch_size=1024)
    assert m.shape == (4096, 1)
    assert abs(m.mean() - 0.5) < 0.05


def test_state_probs_sharded_matches_unsharded(mesh):
    # Same seed: the noise is drawn from one stream and only its rows are
    # split, so the values are those of the unsharded estimator.
    c = Circuit(CIRCUIT)
    sharded = c.compile_state_probs(seed=21, mesh=mesh)
    assert sharded._mesh is mesh
    base = c.compile_state_probs(seed=21, mesh=None, device="cpu")
    state = np.zeros(sharded._program.num_outputs, dtype=np.uint8)
    p_sharded = sharded.probability_of(state, batch_size=64)
    p_base = base.probability_of(state, batch_size=64)
    np.testing.assert_allclose(p_sharded, p_base, rtol=1e-6, atol=1e-9)
    assert ((p_sharded >= 0) & (p_sharded <= 1 + 1e-9)).all()


@pytest.mark.parametrize("batch", [33, 3])
def test_state_probs_sharded_indivisible_batch(mesh, batch):
    # 3 rows on 4 shards leaves one shard empty.
    c = Circuit(CIRCUIT)
    sharded = c.compile_state_probs(seed=22, mesh=mesh)
    state = np.zeros(sharded._program.num_outputs, dtype=np.uint8)
    p = sharded.probability_of(state, batch_size=batch)
    assert p.shape == (batch,) and np.isfinite(p).all()
    base = c.compile_state_probs(seed=22, mesh=None, device="cpu").probability_of(state, batch_size=batch)
    np.testing.assert_allclose(p, base, rtol=1e-6, atol=1e-9)


def test_state_probs_on_d3_replicas_match_unsharded(mesh):
    state = D3.load_state_probs().replay["states"][1]
    sharded = D3.compile_state_probs(seed=0, mesh=mesh).probability_of(state, batch_size=257)
    base = D3.compile_state_probs(seed=0, device="cpu", mesh=None).probability_of(state, batch_size=257)
    np.testing.assert_allclose(sharded, base, rtol=1e-6, atol=0)


# ------------------------------------------------------- against tsim_tpu


@pytest.fixture(scope="module")
def d3_replay():
    sampler = compile_d3()
    u_noise, draws, want, jax_dev = jax_replay(sampler, 4096, 0)
    exported = export_sampler(sampler)
    tables = port_sampler.ProgramTables(exported.program)
    f = DeviceChannelSampler(exported.noise, "cpu").sample_from_uniforms(torch.from_numpy(np.array(u_noise)))
    draws_t = [torch.from_numpy(np.array(d)) for d in draws]
    return tables, f, draws_t, want


def test_sharded_step_matches_tsim_tpu_bits(d3_replay):
    from tests.test_torch_sampler import _borderline_rows

    tables, f, draws, want = d3_replay
    mesh = ShotMesh(["cpu"] * 4)
    got, dev = sharded_sampler_step(tables, mesh)(f, [None] * 4, draws)
    got = got.numpy()
    assert got.shape == want.shape == (4096, 20) and got.dtype == np.uint8
    mismatched = (got != want).any(axis=1)
    near = _borderline_rows(tables, f, draws)
    assert not (mismatched & ~near).any(), np.flatnonzero(mismatched & ~near)
    assert near.mean() < 1e-3
    # The norm deviation is the max of the shards' own.
    cuts = [torch.tensor_split(d, 4) for d in draws]
    shard_devs = []
    for i, fs in enumerate(torch.tensor_split(f, 4)):
        _, shard_dev = port_sampler.sample_program_with_deviation(tables, fs, None, [c[i] for c in cuts])
        shard_devs.append(float(shard_dev[0]))
    assert float(dev[0]) == max(shard_devs) and max(shard_devs) <= 3e-3


def test_sharded_step_with_more_shards_than_rows(d3_replay):
    tables, f, draws, _ = d3_replay
    mesh = ShotMesh(["cpu"] * 4)
    got, _ = sharded_sample_program({torch.device("cpu"): tables}, mesh, f[:3], [None] * 4, [d[:3] for d in draws])
    whole, _ = port_sampler.sample_program_with_deviation(tables, f[:3], None, [d[:3] for d in draws])
    np.testing.assert_array_equal(got.numpy(), whole.numpy())
    empty, dev = sharded_sample_program({torch.device("cpu"): tables}, mesh, f[:0], [None] * 4)
    assert empty.shape == (0, 20) and float(dev[0]) == 0.0


def test_statistics_match_tsim_tpu_sharded_sampler():
    import jax

    import tsim_tpu
    from tsim_tpu.parallel.shard import make_shot_mesh as jax_mesh

    if jax.device_count() < 8:
        pytest.skip("needs tests/conftest.py's 8 virtual CPU devices")
    shots = 16000
    ref = tsim_tpu.Circuit(CIRCUIT).compile_detector_sampler(seed=3, mesh=jax_mesh()).sample(
        shots, batch_size=shots, append_observables=True
    )
    port = Circuit(CIRCUIT).compile_detector_sampler(seed=3, mesh=ShotMesh(["cpu"] * 8)).sample(
        shots, batch_size=shots, append_observables=True
    )
    assert port.shape == ref.shape == (shots, 2)
    assert _z(port, ref).max() < 5.0


# ------------------------------------------------------ shard streams, bit for bit


def _serial_shards(sampler, seed: int, shots: int, batch: int) -> np.ndarray:
    """The sharded batch loop written out: each batch split by shard_sizes,
    each shard's rows drawn by a serial loop on its own seeded generator."""
    n = sampler._mesh.size
    gens = [torch.Generator().manual_seed(shard_seed(seed, i)) for i in range(n)]
    outs = []
    for start in range(0, shots, batch):
        for gen, k in zip(gens, shard_sizes(min(batch, shots - start), n)):
            if k:
                f = sampler._device_channels.sample(gen, k)
                outs.append(port_sampler.sample_program_with_deviation(sampler._tables, f, gen)[0].numpy())
    return np.concatenate(outs).astype(np.bool_)


@pytest.mark.parametrize("shards,shots,batch", [(3, 1000, 300), (4, 600, 256), (2, 5, 4)])
def test_each_shard_is_a_serial_loop_on_its_own_generator(shards, shots, batch):
    sampler = D3.compile_detector_sampler(seed=7, mesh=ShotMesh(["cpu"] * shards))
    got = sampler.sample(shots, batch_size=batch, append_observables=True)
    np.testing.assert_array_equal(got, _serial_shards(sampler, 7, shots, batch))


def test_shards_draw_distinct_streams_and_the_unsharded_stream_is_unchanged():
    two = D3.compile_detector_sampler(seed=5, mesh=ShotMesh(["cpu"] * 2)).sample(
        2000, batch_size=2000, append_observables=True
    )
    assert not np.array_equal(two[:1000], two[1000:])
    assert len({shard_seed(5, i) for i in range(8)} | {5}) == 9
    for mesh in (None, "auto", ShotMesh(["cpu"])):
        sampler = D3.compile_detector_sampler(seed=5, device="cpu", mesh=mesh)
        assert sampler._mesh is None
        got = sampler.sample(600, batch_size=256, append_observables=True)
        np.testing.assert_array_equal(got, _serial(sampler, 5, 600, 256))


def test_postselection_on_a_mesh():
    """Each shard's contiguous share equals the unsharded postselected loop
    on its own generator, in chunks of the batch split over the shards;
    discarded rows were never evaluated; the survivor fraction agrees with
    an unsharded run."""
    mask = np.ones(15, bool)
    sampler = D3.compile_detector_sampler(seed=12, mesh=ShotMesh(["cpu"] * 3))
    shots, batch = 3000, 600
    got = sampler.sample(shots, batch_size=batch, postselection_mask=mask, append_observables=True)
    first = 0
    for i, n in enumerate(shard_sizes(shots, 3)):
        want = _serial_postselected(sampler, shard_seed(12, i), n, batch // 3, mask)
        np.testing.assert_array_equal(got[first : first + n], want)
        first += n
    direct = sampler._direct_detector_mask
    discarded = (got[:, :15] & direct).any(axis=1)
    assert not got[discarded][:, 15:].any() and not got[discarded][:, :15][:, ~direct].any()
    base = D3.compile_detector_sampler(seed=13, device="cpu").sample(
        shots, batch_size=batch, postselection_mask=mask, append_observables=True
    )
    kept = ~(base[:, :15] & direct).any(axis=1)
    assert _z((~discarded)[:, None], kept[:, None]).max() < 5.0
    assert sampler.last_norm_deviation <= 3e-3


def test_postselected_reference_folds_on_a_mesh():
    """With both reference folds a row survives where its direct detectors
    equal the reference's (they read 0 after the fold); a discarded row
    holds nothing but its folded direct detectors; the survivor fraction
    agrees with the unfolded run's."""
    mask = np.ones(15, bool)
    kw = dict(batch_size=200, postselection_mask=mask, append_observables=True)
    mesh = ShotMesh(["cpu"] * 2)
    folded_sampler = D3.compile_detector_sampler(seed=14, mesh=mesh)
    folded = folded_sampler.sample(
        1200, use_detector_reference_sample=True, use_observable_reference_sample=True, **kw
    )
    plain = D3.compile_detector_sampler(seed=15, mesh=mesh).sample(1200, **kw)
    direct = folded_sampler._direct_detector_mask
    discarded = (folded[:, :15] & direct).any(axis=1)
    assert discarded.any() and not discarded.all()
    assert not folded[discarded][:, 15:].any() and not folded[discarded][:, :15][:, ~direct].any()
    kept_plain = ~(plain[:, :15] & direct).any(axis=1)
    assert _z((~discarded)[:, None], kept_plain[:, None]).max() < 5.0


def test_sharded_checkpoint_continues_the_stream(tmp_path):
    path = tmp_path / "sharded.ckpt"
    a = D3.compile_detector_sampler(seed=9, mesh=ShotMesh(["cpu"] * 2))
    a.sample(500, batch_size=250)
    a.save(path)
    b = CompiledDetectorSampler.load(path)
    assert b._mesh == a._mesh and b._mesh.size == 2 and b._mesh_spec == ["cpu", "cpu"]
    np.testing.assert_array_equal(a.sample(400, batch_size=200), b.sample(400, batch_size=200))
    np.testing.assert_array_equal(a.sample(100, batch_size=100), b.sample(100, batch_size=100))


def test_checkpoint_of_a_missing_mesh_device_names_it(tmp_path):
    path = tmp_path / "sharded.ckpt"
    D3.compile_detector_sampler(seed=9, mesh=ShotMesh(["cpu"] * 2)).save(path)
    arrays, header = program_io.read_npz(path)
    header["checkpoint"]["mesh"] = ["cuda:3", "cuda:3"]
    program_io.write_npz(path, arrays, header)
    with pytest.raises(RuntimeError, match="cuda:3"):
        CompiledDetectorSampler.load(path)


# ----------------------- "auto": cards by the device work of a batch


@pytest.fixture(scope="module")
def d3_work():
    """d3 distillation's device work a row, the reference of "auto"'s rule."""
    return D3.compile_detector_sampler(seed=0, device="cpu")._seconds_per_row()


def test_d3_is_the_reference_work(d3_work):
    assert port_sampler.AUTO_MIN_ROWS_PER_CARD == 2**19
    assert d3_work == pytest.approx(port_sampler.AUTO_REFERENCE_SECONDS_PER_ROW, rel=1e-12)
    assert d3_work * sample_eval.F32_OPS_PER_S == pytest.approx(10_140)


@pytest.mark.parametrize(
    "rows,cards,want",
    [(1, 4, 1), (2**19, 4, 1), (2**20 - 1, 4, 1), (2**20, 4, 2), (3 * 2**19, 4, 3),
     (2**21, 4, 4), (2**24, 4, 4), (2**24, 2, 2), (2**21, 8, 4), (2**20, 1, 1)],
)
def test_auto_gives_each_card_its_minimum_rows(rows, cards, want, d3_work):
    # d3 keeps 2^19 rows a card: its work is the reference.
    assert port_sampler.auto_cards(rows, cards, card_rows=2**40, seconds_per_row=d3_work) == want


@pytest.mark.parametrize(
    "times,rows,want",
    [(8, 2**20, 4), (8, 2**18, 1), (8, 2**19, 2), (8, 3 * 2**18, 3), (2, 2**20, 4), (2, 2**19, 2),
     (0.5, 2**20, 1), (0.5, 2**21, 2), (0.5, 2**22, 4), (1.5, 3 * 2**20, 4)],
)
def test_auto_cards_scale_with_the_work_a_row(times, rows, want, d3_work):
    """A program of ``times`` d3's work a row: 2^19 / times rows a card, at
    least AUTO_FLOOR_ROWS_PER_CARD = 2^18."""
    assert port_sampler.AUTO_FLOOR_ROWS_PER_CARD == 2**18
    assert port_sampler.auto_cards(rows, 4, card_rows=2**40, seconds_per_row=times * d3_work) == want


@pytest.mark.parametrize(
    "program,evaluation,want",
    [("d3", "f32", [1, 1, 2, 4]), ("d3", "exact", [1, 2, 4, 4]), ("checks1", "f32", [1, 1, 2, 4]),
     ("checks2", "f32", [1, 2, 4, 4]), ("checks2", "exact", [1, 2, 4, 4])],
)
def test_auto_cards_of_the_committed_programs(program, evaluation, want):
    """Cards of four at batches of 2^18 to 2^21 rows: 2-check cultivation,
    f32 and exact, takes every card at 2^20 as the memory budget alone made
    it do before, by its work; d3 and 1-check cultivation keep the rows rule."""
    from tsim_tpu_torch.models.exported import cultivation_d3

    circuit = {"d3": D3, "checks1": cultivation_d3(p=0.001, checks=1),
               "checks2": cultivation_d3(p=0.001, checks=2)}[program]
    work = circuit.compile_detector_sampler(seed=0, device="cpu", evaluation=evaluation)._seconds_per_row()
    got = [port_sampler.auto_cards(2**k, 4, card_rows=2**40, seconds_per_row=work) for k in range(18, 22)]
    assert got == want


@pytest.mark.parametrize(
    "rows,cards,card_rows,want",
    [(2**20, 4, 2**18, 4), (2**20, 4, 2**19, 2), (2**20, 4, 3 * 2**18, 2), (3 * 2**17, 4, 2**17, 3),
     (100, 4, 30, 4), (100, 4, 50, 2), (100, 4, 100, 1), (10**9, 4, 10, 4), (2**22, 2, 2**20, 2)],
)
def test_auto_takes_more_cards_where_one_card_budget_is_exceeded(rows, cards, card_rows, want, d3_work):
    k = port_sampler.auto_cards(rows, cards, card_rows, d3_work)
    assert k == want
    # No card gets more than its budget unless every card is taken.
    assert max(shard_sizes(rows, k)) <= card_rows or k == cards


@pytest.fixture
def auto_replicas(monkeypatch):
    """"auto" resolving to four CPU replicas, each needing 64 rows a batch
    (every program given d3's work a row)."""
    monkeypatch.setattr(port_sampler, "_auto_mesh", lambda: ShotMesh(["cpu"] * 4))
    monkeypatch.setattr(port_sampler, "AUTO_MIN_ROWS_PER_CARD", 64)
    monkeypatch.setattr(port_sampler, "AUTO_FLOOR_ROWS_PER_CARD", 1)
    monkeypatch.setattr(port_sampler._CompiledSamplerBase, "_seconds_per_row",
                        lambda self: port_sampler.AUTO_REFERENCE_SECONDS_PER_ROW)
    return monkeypatch


@pytest.mark.parametrize("batch,shards", [(32, 1), (64, 1), (127, 1), (128, 2), (200, 3), (1000, 4)])
def test_auto_draws_the_stream_of_the_cards_a_batch_takes(auto_replicas, batch, shards):
    c = Circuit(CIRCUIT)
    auto = c.compile_detector_sampler(seed=5)
    assert auto._mesh_spec == "auto" and auto._mesh.size == 4
    assert len(auto._shards_for(batch)) == shards
    explicit = c.compile_detector_sampler(
        seed=5, device="cpu", mesh=None if shards == 1 else ShotMesh(["cpu"] * shards)
    )
    np.testing.assert_array_equal(
        auto.sample(2 * batch + 7, batch_size=batch), explicit.sample(2 * batch + 7, batch_size=batch)
    )


@pytest.mark.parametrize("shots,batch", [(100, None), (1000, None), (7, None), (200, 25), (200, 64)])
def test_auto_batch_and_cards_fit_a_small_card_budget(auto_replicas, shots, batch):
    """A card's memory budget under the rows rule: the default batch is the
    budget times the cards, and no card is given more than its budget."""
    auto_replicas.setattr(port_sampler._CompiledSamplerBase, "_card_rows", lambda self, postselected=False: 10)
    c = Circuit(CIRCUIT)
    auto = c.compile_detector_sampler(seed=4)
    size, shards = auto._plan_batches(shots, batch)
    assert size == (batch or ceil(shots / ceil(shots / 40)))
    assert max(shard_sizes(min(size, shots), len(shards))) <= 10 or len(shards) == 4
    k = len(shards)
    explicit = c.compile_detector_sampler(
        seed=4, device="cpu", mesh=None if k == 1 else ShotMesh(["cpu"] * k))
    np.testing.assert_array_equal(auto.sample(shots, batch_size=batch), explicit.sample(shots, batch_size=size))


def test_auto_postselection_and_state_probs_take_the_same_cards(auto_replicas):
    c = Circuit(CIRCUIT)
    mask = np.ones(1, dtype=bool)
    for batch, mesh in ((48, None), (256, ShotMesh(["cpu"] * 4))):
        auto = c.compile_detector_sampler(seed=2).sample(
            300, batch_size=batch, postselection_mask=mask, separate_observables=True)
        explicit = c.compile_detector_sampler(seed=2, device="cpu", mesh=mesh).sample(
            300, batch_size=batch, postselection_mask=mask, separate_observables=True)
        for a, b in zip(auto, explicit):
            np.testing.assert_array_equal(a, b)
    state = np.zeros(D3.load_state_probs().program.num_outputs, dtype=np.uint8)
    auto = D3.compile_state_probs(seed=3)
    assert auto._mesh.size == 4
    np.testing.assert_array_equal(
        auto.probability_of(state, batch_size=200),
        D3.compile_state_probs(seed=3, device="cpu", mesh=None).probability_of(state, batch_size=200),
    )


def test_auto_checkpoint_keeps_the_resolved_cards(auto_replicas, tmp_path):
    path = tmp_path / "auto.ckpt"
    a = D3.compile_detector_sampler(seed=9)
    a.sample(256, batch_size=128)  # two of the four cards
    a.save(path)
    _, header = program_io.read_npz(path)
    assert header["checkpoint"]["mesh"] == "auto"
    assert header["checkpoint"]["mesh_devices"] == ["cpu"] * 4
    # The loader's own "auto" would resolve to other cards: the checkpoint's hold.
    auto_replicas.setattr(port_sampler, "_auto_mesh", lambda: ShotMesh(["cpu"] * 2))
    b = CompiledDetectorSampler.load(path)
    assert b._mesh_spec == "auto" and b._mesh == a._mesh
    for batch in (128, 32, 1000):
        np.testing.assert_array_equal(
            a.sample(2 * batch, batch_size=batch), b.sample(2 * batch, batch_size=batch)
        )


# ------------------------------------------------------------- the mesh itself


def test_shot_mesh_resolves_and_validates():
    m = ShotMesh(["cpu", torch.device("cpu"), "cpu"])
    assert m.size == 3 and m.distinct == (torch.device("cpu"),) and m.axis_names == ("shots",)
    assert m == ShotMesh(["cpu"] * 3) and hash(m) == hash(ShotMesh(["cpu"] * 3))
    assert ShotMesh(["cpu"], axis_name="batch").axis_names == ("batch",)
    with pytest.raises(ValueError):
        ShotMesh([])
    assert shard_sizes(10, 4) == [3, 3, 2, 2] == [len(t) for t in torch.tensor_split(torch.arange(10), 4)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_shot_mesh()
        with pytest.raises(RuntimeError, match="not available"):
            ShotMesh(["cuda"])
    assert make_shot_mesh(["cpu"] * 2) == ShotMesh(["cpu"] * 2)


def test_a_device_that_repeats_and_the_sampler_device():
    c = Circuit(CIRCUIT)
    mesh = ShotMesh(["cpu"] * 2)
    s = c.compile_detector_sampler(seed=0, device="cpu", mesh=mesh)
    assert s._mesh is mesh and len(s._replicas) == 1 and len(s._shards) == 2
    assert s._shards[0].tables is s._shards[1].tables is s._tables
    assert s._shards[0].generator is not s._shards[1].generator
    with pytest.raises(ValueError, match="first device"):
        c.compile_detector_sampler(seed=0, device="cuda:0", mesh=mesh)
    one = c.compile_detector_sampler(seed=0, mesh=ShotMesh(["cpu"]))
    assert one._mesh is None and one.device == torch.device("cpu")
    with pytest.raises(ValueError, match="auto"):
        c.compile_detector_sampler(seed=0, device="cpu", mesh="all")
    with pytest.raises(TypeError, match="ShotMesh"):
        c.compile_detector_sampler(seed=0, device="cpu", mesh=["cpu", "cpu"])


def test_batch_estimate_counts_every_shard(monkeypatch):
    # Four replicas share the CPU's 4 GiB: the same rows in all, to rounding,
    # each shard's the budget of its share (below DEFAULT_ROWS_PER_CARD).
    pages = {"SC_AVPHYS_PAGES": 1 << 20, "SC_PAGE_SIZE": 4096}
    monkeypatch.setattr(port_sampler.os, "sysconf", pages.__getitem__)
    single = D3.compile_detector_sampler(seed=0, device="cpu")
    unsharded = single._estimate_batch_size()
    sharded = D3.compile_detector_sampler(seed=0, mesh=ShotMesh(["cpu"] * 4))._estimate_batch_size()
    assert unsharded == (1 << 31) // single._peak_bytes_per_sample(torch.device("cpu"))
    assert unsharded < port_sampler.DEFAULT_ROWS_PER_CARD
    assert unsharded - 4 < sharded <= unsharded and sharded % 4 == 0


def test_batch_estimate_is_the_ceiling_on_every_shard(monkeypatch):
    """With memory to spare each shard takes DEFAULT_ROWS_PER_CARD rows."""
    pages = {"SC_AVPHYS_PAGES": 1 << 26, "SC_PAGE_SIZE": 4096}
    monkeypatch.setattr(port_sampler.os, "sysconf", pages.__getitem__)
    unsharded = D3.compile_detector_sampler(seed=0, device="cpu")._estimate_batch_size()
    sharded = D3.compile_detector_sampler(seed=0, mesh=ShotMesh(["cpu"] * 4))._estimate_batch_size()
    assert unsharded == port_sampler.DEFAULT_ROWS_PER_CARD and sharded == 4 * unsharded


def test_fully_direct_programs_ignore_the_mesh():
    text = "X_ERROR(0.2) 0\nM 0\nDETECTOR rec[-1]"
    a = Circuit(text).compile_detector_sampler(seed=1, mesh=ShotMesh(["cpu"] * 3)).sample(500)
    b = Circuit(text).compile_detector_sampler(seed=1, device="cpu").sample(500)
    np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ on the card


@pytest.mark.cuda
def test_card_replicas_equal_serial_loops_per_shard():
    _needs_card()
    sampler = D3.compile_detector_sampler(seed=16, mesh=ShotMesh(["cuda:0"] * 2))
    sample_eval.ensure_self_test("cuda:0")  # here, and not inside the counted call
    kernel.reset_launch_counts()
    got = sampler.sample(3 * 4096 + 5, batch_size=4096, append_observables=True)
    # Each replica ran the ladder's three small rungs in each of 4 batches.
    assert kernel.device_launch_counts["cuda:0"]["small"] == 2 * 4 * 3
    n = sampler._mesh.size
    gens = [torch.Generator(device="cuda:0").manual_seed(shard_seed(16, i)) for i in range(n)]
    outs = []
    for start in range(0, got.shape[0], 4096):
        for gen, k in zip(gens, shard_sizes(min(4096, got.shape[0] - start), n)):
            f = sampler._device_channels.sample(gen, k)
            outs.append(port_sampler.sample_program_with_deviation(sampler._tables, f, gen)[0].cpu().numpy())
    np.testing.assert_array_equal(got, np.concatenate(outs).astype(bool))


@pytest.mark.cuda
def test_card_state_probs_on_a_mesh_equal_unsharded():
    _needs_card()
    mesh = make_shot_mesh() if torch.cuda.device_count() > 1 else ShotMesh(["cuda:0"] * 2)
    state = D3.load_state_probs().replay["states"][0]
    a = D3.compile_state_probs(seed=3, mesh=mesh).probability_of(state, batch_size=4099)
    b = D3.compile_state_probs(seed=3, device="cuda:0", mesh=None).probability_of(state, batch_size=4099)
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_auto_mesh_on_the_cards():
    _needs_card()
    s = D3.compile_detector_sampler(seed=0)
    if torch.cuda.device_count() > 1:
        assert s._mesh == make_shot_mesh() and s._mesh_spec == "auto"
    else:
        assert s._mesh is None and s.device == torch.device("cuda", torch.cuda.current_device())
    assert D3.compile_detector_sampler(seed=0, device="cuda")._mesh is None


@pytest.mark.cuda
def test_self_test_runs_once_per_card_whatever_the_spelling():
    _needs_card()
    sample_eval.reset_self_test()
    kernel.reset_launch_counts()
    a = D3.compile_detector_sampler(seed=0, device="cuda", mesh=None)
    b = D3.compile_detector_sampler(seed=0, device="cuda:0", mesh=None)
    assert a.device == b.device == torch.device("cuda:0")
    a.sample(1024, batch_size=1024)
    b.sample(1024, batch_size=1024)
    sample_eval.ensure_self_test("cuda")
    sample_eval.ensure_self_test("cuda:0")
    assert kernel.launch_counts["self_test"] == len(kernel.CONFIGURATIONS)
