"""Checkpoints of the port's samplers: save/load continue the sample stream.

Mirrors ``tests/unit/test_checkpoint.py`` on programs that tsim_tpu compiles
from the same circuits and ``export_sampler`` hands to the port, and adds
``CompiledStateProbs`` on the committed d3 program. A checkpoint is one
``.npz`` (the program as ``program_io`` writes it, the class, seed, device
type, options and the generator's state), read without pickle.
"""

import numpy as np
import pytest
import torch

import tsim_tpu
from dev.export_torch_program import export_sampler
from tsim_tpu_torch import program_io
from tsim_tpu_torch.models.exported import distillation_d3
from tsim_tpu_torch.sampler import CompiledDetectorSampler, CompiledMeasurementSampler, CompiledStateProbs

TEXT = """
H 0
T 0
CNOT 0 1
X_ERROR(0.2) 0
DEPOLARIZE1(0.1) 1
M 0 1
DETECTOR rec[-1] rec[-2]
OBSERVABLE_INCLUDE(0) rec[-1]
"""


def _detector_sampler(seed=5, **kw):
    exported = export_sampler(tsim_tpu.Circuit(TEXT).compile_detector_sampler(seed=0))
    return CompiledDetectorSampler(exported, seed=seed, device="cpu", **kw)


def _measurement_sampler(seed=7):
    exported = export_sampler(tsim_tpu.Circuit("H 0\nT 0\nM 0").compile_sampler(seed=0))
    return CompiledMeasurementSampler(exported, seed=seed, device="cpu")


def test_detector_sampler_roundtrip(tmp_path):
    path = tmp_path / "sampler.ckpt"
    a = _detector_sampler()
    a.save(path)
    b = CompiledDetectorSampler.load(path)
    # Both continue the identical sample stream.
    sa = a.sample(500, batch_size=500)
    sb = b.sample(500, batch_size=500)
    np.testing.assert_array_equal(sa, sb)
    # And keep agreeing on the next call (the generators advanced alike).
    np.testing.assert_array_equal(a.sample(100, batch_size=100), b.sample(100, batch_size=100))


def test_measurement_sampler_roundtrip(tmp_path):
    path = tmp_path / "m.ckpt"
    a = _measurement_sampler()
    a.save(path)
    b = CompiledMeasurementSampler.load(path)
    np.testing.assert_array_equal(a.sample(200, batch_size=200), b.sample(200, batch_size=200))


def test_wrong_class_raises(tmp_path):
    path = tmp_path / "m.ckpt"
    _measurement_sampler().save(path)
    with pytest.raises(TypeError):
        CompiledDetectorSampler.load(path)


def test_state_probs_roundtrip(tmp_path):
    """d3's state probabilities, saved after one call: the restored object
    draws the same noise and gives the same probabilities on the next two."""
    circuit = distillation_d3(p=0.05)
    state = circuit.load_state_probs().replay["states"][0]
    a = circuit.compile_state_probs(seed=3, device="cpu")
    a.probability_of(state, batch_size=16)
    path = tmp_path / "sp.ckpt"
    a.save(path)
    b = CompiledStateProbs.load(path)
    for _ in range(2):
        np.testing.assert_array_equal(a.probability_of(state, batch_size=32), b.probability_of(state, batch_size=32))
    with pytest.raises(TypeError):
        CompiledDetectorSampler.load(path)


def test_checkpoint_keeps_options_and_continues_mid_stream(tmp_path):
    """Saved after sampling, with exact evaluation: the options come back and
    the next shots agree, postselected ones included."""
    a = _detector_sampler(seed=9, evaluation="exact")
    a.sample(300, batch_size=128)
    path = tmp_path / "exact.ckpt"
    a.save(path)
    b = CompiledDetectorSampler.load(path)
    assert b.evaluation == "exact" and b.device.type == "cpu"
    mask = np.ones(1, bool)
    np.testing.assert_array_equal(
        a.sample(400, batch_size=128, postselection_mask=mask),
        b.sample(400, batch_size=128, postselection_mask=mask),
    )


def test_program_file_is_not_a_checkpoint(tmp_path):
    path = tmp_path / "program.npz"
    program_io.save_npz(path, distillation_d3(p=0.05).load())
    with pytest.raises(ValueError, match="not a sampler checkpoint"):
        CompiledDetectorSampler.load(path)


def test_cuda_checkpoint_needs_a_card(tmp_path):
    """A checkpoint saved on the card restores onto the card: without one it
    raises, as a sampler built with ``device=None`` does; no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    path = tmp_path / "cuda.ckpt"
    _detector_sampler().save(path)
    arrays, header = program_io.read_npz(path)
    header["checkpoint"]["device"] = "cuda"
    program_io.write_npz(path, arrays, header)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CompiledDetectorSampler.load(path)
