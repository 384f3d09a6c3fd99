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
from tsim_tpu_torch.compile.sample_eval import evaluate_abs_sample
from tsim_tpu_torch.models.exported import cultivation_d3, distillation_d3
from tsim_tpu_torch.noise.device_channels import DeviceChannelSampler
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
    assert s._estimate_batch_size() >= 1
    assert s.sample(100).shape == (100, 15)


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
