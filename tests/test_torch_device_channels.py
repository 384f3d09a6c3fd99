"""The port's device noise draw against tsim_tpu's DeviceChannelSampler.

Fed JAX's own uniforms (``DeviceChannelSampler.sample`` starts with
``jax.random.uniform(key, (batch, C))``), the port must give identical
bits, on the packed-word path (``num_f <= 31``) and the bitplane path.
The torch.Generator path is checked statistically against the host
sampler, as ``tests/unit/noise/test_device_channels.py`` checks tsim_tpu's.
The table the card's kernel draws from (``noise/device_channels.py::
draw_table``), read on the host as the kernel reads it, must give the plain
draw's bits on the noise of every committed program and on seeded channel
sets, with uniforms at and just past the CDF entries.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from dev.export_torch_program import compile_d3
from tsim_tpu.noise.channels import (
    ChannelSampler,
    error_probs,
    heralded_pauli_channel_1_probs,
    pauli_channel_1_probs,
    pauli_channel_2_probs,
)
from tsim_tpu.noise.device_channels import DeviceChannelSampler as JaxDeviceChannelSampler
from tsim_tpu_torch.kernels import noise_draw as noise_kernel
from tsim_tpu_torch.noise.device_channels import DeviceChannelSampler, read_draw_table
from tsim_tpu_torch.program_io import noise_from_reference


def _same_bits(host: ChannelSampler, batch: int, seed: int):
    ref = JaxDeviceChannelSampler(host)
    port = DeviceChannelSampler(noise_from_reference(host), "cpu")
    assert port.packed == ref.packed and port.num_channels == ref.num_channels
    key = jax.random.key(seed)
    u = np.asarray(jax.random.uniform(key, (batch, ref.num_channels), dtype=jax.numpy.float32))
    want = np.asarray(ref.sample(key, batch))
    got = port.sample_from_uniforms(torch.from_numpy(u.copy())).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return port


def _multibit_transform(num_f: int, seed: int):
    """pc1, pc2 and heralded channels spread over ``num_f`` f columns."""
    rng = np.random.default_rng(seed)
    probs = [
        pauli_channel_1_probs(0.1, 0.2, 0.15),
        pauli_channel_2_probs(*([0.03] * 15)),
        heralded_pauli_channel_1_probs(0.1, 0.05, 0.05, 0.1),
        error_probs(0.3),
        error_probs(0.45),
    ] * 4
    n_e = sum(int(np.log2(len(p))) for p in probs)
    transform = rng.integers(0, 2, size=(num_f, n_e)).astype(np.uint8)
    return probs, transform


def test_packed_path_d3_identical_bits():
    host = compile_d3()._channel_sampler
    port = _same_bits(host, batch=4096, seed=3)
    assert port.packed and port.num_f == 21 and port.num_channels == 78
    assert [o for (_, _, o) in port.buckets] == [4, 8, 16]


@pytest.mark.parametrize("num_f,packed", [(12, True), (31, True), (40, False), (70, False)])
def test_multibit_channels_identical_bits(num_f, packed):
    probs, transform = _multibit_transform(num_f, seed=num_f)
    port = _same_bits(ChannelSampler(probs, transform, seed=1), batch=2048, seed=num_f)
    assert port.packed == packed


def test_generator_path_matches_host_statistics():
    probs, transform = _multibit_transform(40, seed=2)
    host = ChannelSampler(probs, transform, seed=11)
    n = 200_000
    port = DeviceChannelSampler(noise_from_reference(host), "cpu")
    gen = torch.Generator().manual_seed(7)
    f_dev = port.sample(gen, n).numpy()
    f_host = host.sample(n)
    assert f_dev.shape == f_host.shape
    a, b = f_dev.mean(axis=0), f_host.mean(axis=0)
    se = np.sqrt(b * (1 - b) / n + a * (1 - a) / n) + 1e-9
    assert (np.abs(a - b) / se).max() < 4.5, (a, b)


def test_zero_noise():
    host = ChannelSampler([error_probs(0.0)], np.eye(1, dtype=np.uint8), seed=1)
    port = DeviceChannelSampler(noise_from_reference(host), "cpu")
    f = port.sample(torch.Generator().manual_seed(0), 64)
    assert f.shape == (64, 1) and not f.any()


# ---------------------------------------------------- the kernel's draw table

def _committed_noise():
    from tsim_tpu_torch.models.exported import SURFACE_D7_PROGRAM, cultivation_d3, distillation_d3, distillation_d5
    from tsim_tpu_torch.program_io import load_npz

    return {
        "d3": lambda: distillation_d3(p=0.05).load().noise,
        "d3_state_probs": lambda: distillation_d3(p=0.05).load_state_probs().noise,
        "checks1": lambda: cultivation_d3(p=0.001, checks=1).load().noise,
        "checks2": lambda: cultivation_d3(p=0.001, checks=2).load().noise,
        "d5": lambda: distillation_d5(p=0.02).load().noise,
        "d7": lambda: load_npz(SURFACE_D7_PROGRAM).noise,
    }


COMMITTED_NOISE = _committed_noise()


def _edge_uniforms(sampler: DeviceChannelSampler, rows: int, seed: int) -> np.ndarray:
    """Seeded uniforms whose first rows put every channel at and just past
    each of its CDF entries (and at 0 and the largest float32 below 1)."""
    u = np.random.default_rng(seed).random((rows, sampler.num_channels), dtype=np.float32)
    C = sampler.num_channels
    offsets = sampler.table[: C + 1]
    cdf = sampler.table[C + 1 : C + 1 + sampler.cdf_entries].view(np.float32)
    below_one = np.nextafter(np.float32(1), np.float32(0))
    for c in range(C):
        entries = cdf[offsets[c] : offsets[c + 1]]
        edges = np.concatenate([entries, np.nextafter(entries, np.float32(2)), [0, below_one]])
        edges = np.minimum(edges, below_one).astype(np.float32)
        u[: len(edges), c] = edges
    return u


def _assert_reader_equals_plain(sampler: DeviceChannelSampler, rows: int, seed: int) -> None:
    u = _edge_uniforms(sampler, rows, seed)
    want = sampler.sample_from_uniforms(torch.from_numpy(u)).numpy()
    got = read_draw_table(sampler.table, sampler.num_channels, sampler.num_f, u)
    assert got.dtype == np.uint8 and got.shape == want.shape == (rows, sampler.num_f)
    np.testing.assert_array_equal(got, want)
    # On the CPU the dispatch takes the plain version.
    np.testing.assert_array_equal(sampler.from_uniforms(torch.from_numpy(u)).numpy(), want)


@pytest.mark.parametrize("program", sorted(COMMITTED_NOISE))
def test_draw_table_reader_equals_plain_draw_on_committed_noise(program):
    """The plain reader of the kernel's table gives the plain draw's bits,
    bit for bit, on every committed program's noise (d7: W = 11 words)."""
    sampler = DeviceChannelSampler(COMMITTED_NOISE[program](), "cpu")
    assert sampler.words == max(1, -(-sampler.num_f // 32))
    assert sampler.table.size == noise_kernel.table_words(sampler.num_channels, sampler.cdf_entries, sampler.words)
    if program == "d7":
        assert sampler.words == 11 and not sampler.packed
    _assert_reader_equals_plain(sampler, 512, seed=len(program))


def _random_noise(num_f: int, seed: int):
    """Seeded channels of 1 to 4 error bits (2 to 16 outcomes), one of them
    dead, over a random signature matrix of ``num_f`` columns."""
    rng = np.random.default_rng(seed)
    num_sigs = 24
    sig = rng.integers(0, 2, size=(num_sigs, num_f), dtype=np.uint8)
    channels = []
    for i in range(40):
        k = int(rng.integers(1, 5))
        probs = rng.dirichlet(np.ones(2**k)) * rng.uniform(0.01, 0.5)
        probs[0] += 1 - probs.sum()
        if i == 7:
            probs = np.eye(2**k)[0]
        ids = tuple(int(j) for j in rng.choice(num_sigs, size=k, replace=False))
        channels.append(SimpleNamespace(probs=probs, unique_col_ids=ids))
    return SimpleNamespace(channels=tuple(channels), signature_matrix=sig)


@pytest.mark.parametrize("num_f", [12, 31, 32, 40, 70, 337])
def test_draw_table_reader_equals_plain_draw_on_seeded_channels(num_f):
    sampler = DeviceChannelSampler(_random_noise(num_f, seed=num_f), "cpu")
    assert sampler.num_channels == 39 and sampler.packed == (num_f <= 31)
    assert max(o for _, _, o in sampler.buckets) == 16
    _assert_reader_equals_plain(sampler, 256, seed=num_f)


@pytest.mark.parametrize("program", ["d3", "d5"])
def test_noise_draw_bytes_by_device(program):
    """The card's count is the uniforms and the kernel's output; the CPU's
    is the plain version's (held to what it allocates in
    ``tests/test_torch_sampler.py``)."""
    sampler = DeviceChannelSampler(COMMITTED_NOISE[program](), "cpu")
    C, F = sampler.num_channels, sampler.num_f
    assert sampler.peak_bytes_per_shot(torch.device("cuda:0")) == 4 * C + F
    assert sampler.peak_bytes_per_shot("cpu") > 4 * C + F


def test_noise_draw_wrapper_refuses_cpu_tensors():
    sampler = DeviceChannelSampler(COMMITTED_NOISE["d3"](), "cpu")
    u = torch.rand((4, sampler.num_channels))
    with pytest.raises(ValueError, match="CUDA tensors"):
        noise_kernel.draw(sampler._table, u, sampler.cdf_entries, sampler.words, sampler.num_f)
