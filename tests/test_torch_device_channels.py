"""The port's device noise draw against tsim_tpu's DeviceChannelSampler.

Fed JAX's own uniforms (``DeviceChannelSampler.sample`` starts with
``jax.random.uniform(key, (batch, C))``), the port must give identical
bits, on the packed-word path (``num_f <= 31``) and the bitplane path.
The torch.Generator path is checked statistically against the host
sampler, as ``tests/unit/noise/test_device_channels.py`` checks tsim_tpu's.
"""

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
from tsim_tpu_torch.noise.device_channels import DeviceChannelSampler
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
