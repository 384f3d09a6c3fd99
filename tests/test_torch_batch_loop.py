"""The sampler's pipelined batch loop against a serial loop, on the CPU.

``sample()`` enqueues batch k + 1's noise draw and ladder before it moves
batch k's bits to the host (``sampler._RowsToHost``), draws exactly the shots
a last batch needs, and keeps postselection's prefilter, survivor pool and
scatter on the device. Here its output must equal, bit for bit, a serial
loop written out over ``sample_program_with_deviation`` on the same seed and
batch sizes (noise, then ladder, batch by batch; postselection with a host
scatter of each evaluated survivor batch, as the sampler did before), on d3
distillation and 1-check cultivation, with a short last batch, with and
without postselection.
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
