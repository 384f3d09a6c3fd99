"""The port's sampler against tsim_tpu's, bit for bit on injected randomness.

JAX's threefry and torch's generators give different streams, so the
test replays tsim_tpu's key schedule for one batch: the per-batch
``fold_in`` of the noise and sampling keys (``sampler.py:156-157``), the
noise uniforms, then one ``split`` per rung for the Bernoulli draws
(``sampler.py:75``; ``bernoulli(key, p)`` is ``uniform(key) < p``). The
port gets the same uniforms. tsim_tpu on the CPU evaluates exactly, the
port in f32, so a draw may differ only where the uniform lies within
1e-4 of the probability; such rows must be rare.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tsim_tpu
import tsim_tpu.sampler as jax_sampler_mod
from dev.export_torch_program import compile_d3, export_sampler
from tsim_tpu_torch import sampler as port_sampler
from tsim_tpu_torch.compile.sample_eval import evaluate_abs_sample
from tsim_tpu_torch.models import distillation_d3
from tsim_tpu_torch.noise.device_channels import DeviceChannelSampler
from tsim_tpu_torch.ops.gf2 import static_take_columns

BORDER = 1e-4


def _jax_replay(sampler, batch, seed):
    """tsim_tpu's batch-0 randomness and outputs: (noise u, draw u's, bits, deviation)."""
    program, dc = sampler._program, sampler._device_channels
    base = jax.random.key(seed)
    k_noise, k_sample = jax.random.fold_in(base, 0), jax.random.fold_in(base, 1)
    u_noise = np.asarray(jax.random.uniform(k_noise, (batch, dc.num_channels), dtype=jnp.float32))
    f = dc.sample(k_noise, batch)
    bits, dev = jax_sampler_mod.sample_program_with_deviation(program, f, k_sample)
    draws, key = [], k_sample
    for comp in program.components:
        for _ in comp.compiled_scalar_graphs[1:]:
            key, dk = jax.random.split(key)
            draws.append(np.asarray(jax.random.uniform(dk, (batch,), dtype=jnp.float32)))
    return u_noise, draws, np.asarray(bits), float(np.asarray(dev)[0])


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


def _compare_with_jax(sampler, batch, seed):
    u_noise, draws, want, jax_dev = _jax_replay(sampler, batch, seed)
    exported = export_sampler(sampler)
    tables = port_sampler.ProgramTables(exported.program)
    noise = DeviceChannelSampler(exported.noise, "cpu")
    f = noise.sample_from_uniforms(torch.from_numpy(u_noise.copy()))
    draws_t = [torch.from_numpy(d.copy()) for d in draws]
    got, dev = port_sampler.sample_program_with_deviation(tables, f, None, uniforms=draws_t)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == np.uint8
    mismatched = (got != want).any(axis=1)
    near = _borderline_rows(tables, f, draws_t)
    assert not (mismatched & ~near).any(), np.flatnonzero(mismatched & ~near)
    return got, float(dev[0]), jax_dev, near.mean()


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


def test_pack_bitplanes_matches_tsim_tpu():
    rng = np.random.default_rng(0)
    for batch in (1, 8, 1001):
        out = rng.integers(0, 2, size=(batch, 20)).astype(np.uint8)
        want = np.asarray(jax_sampler_mod._pack_bitplanes(jnp.asarray(out)))
        got = port_sampler._pack_bitplanes(torch.from_numpy(out)).numpy()
        np.testing.assert_array_equal(got, want)


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


def test_unported_options_raise(d3):
    s = d3.compile_detector_sampler(seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="postselection"):
        s.sample(10, postselection_mask=np.zeros(15, bool))
    with pytest.raises(NotImplementedError, match="reference"):
        s.sample(10, use_detector_reference_sample=True)
    with pytest.raises(ValueError, match="mutually exclusive"):
        s.sample(10, separate_observables=True, append_observables=True)
    with pytest.raises(NotImplementedError, match="distillation_d3"):
        distillation_d3(p=0.01)


def test_fully_direct_program_raises():
    sampler = tsim_tpu.Circuit("X_ERROR(0.1) 0\nM 0\nDETECTOR rec[-1]").compile_detector_sampler(seed=0)
    exported = export_sampler(sampler)
    assert not exported.program.components
    port = port_sampler.CompiledDetectorSampler(exported, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="fully-direct"):
        port.sample(10)


def test_norm_deviation_check():
    port_sampler._check_norm_deviation(torch.tensor([1e-4]))
    with pytest.raises(ValueError, match="vanishing"):
        port_sampler._check_norm_deviation(torch.tensor([1.0]))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        port_sampler._check_norm_deviation(torch.tensor([1e-2]))
    assert any("not normalized" in str(w.message) for w in caught)


def test_default_batch_size_on_cpu(d3):
    s = d3.compile_detector_sampler(seed=0, device="cpu")
    assert s._estimate_batch_size() >= 1
    assert s.sample(100).shape == (100, 15)
