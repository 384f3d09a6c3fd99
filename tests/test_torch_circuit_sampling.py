"""The whole slice on the CPU: circuits built, compiled and sampled by the port.

* ``distillation_d3(p=0.05).compile_detector_sampler(seed=0, device="cpu")``
  samples bit for bit what the sampler built from the committed program
  samples on the same seed (the program and noise model are equal, and the
  sample stream is the generator's);
* ``logical_distillation_circuit(p=0.0, noise=0.0)``, whose noise channels
  (``DEPOLARIZE1(0.0)``) never fire, meets
  ``tests/integration/test_sampler_circuits.py``'s bounds;
* with ``jax`` and ``tsim_tpu`` blocked, a subprocess builds, compiles and
  samples d3, so the card's machine needs neither;
* ``compile_stats``, the ``__repr__`` dashboard (equal to tsim_tpu's),
  ``compile_state_probs(sample_detectors=...)`` and a checkpoint of a
  sampler compiled from a circuit.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import tsim_tpu
import tsim_tpu_torch
from tests.test_torch_compile_parity import assert_same_leaves, reference_compile
from tsim_tpu_torch import models
from tsim_tpu_torch.models import exported

REPO = Path(__file__).resolve().parents[1]
SHOTS, BATCH = 4096, 1024


def test_compiled_d3_samples_equal_committed_program_samples():
    circuit = models.distillation_d3(p=0.05)
    compiled = circuit.compile_detector_sampler(seed=0, device="cpu")
    committed = exported.distillation_d3(p=0.05).compile_detector_sampler(seed=0, device="cpu")
    got = compiled.sample(SHOTS, batch_size=BATCH, append_observables=True)
    want = committed.sample(SHOTS, batch_size=BATCH, append_observables=True)
    assert got.shape == (SHOTS, 20) and got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)
    assert compiled.last_norm_deviation == committed.last_norm_deviation


def test_compiled_d3_state_probabilities_equal_committed_program():
    d3 = exported.distillation_d3(p=0.05)
    state = d3.load_state_probs().replay["states"][1]
    got = models.distillation_d3(p=0.05).compile_state_probs(seed=0, device="cpu")
    want = d3.compile_state_probs(seed=0, device="cpu")
    np.testing.assert_array_equal(
        got.probability_of(state, batch_size=256), want.probability_of(state, batch_size=256)
    )


def test_noiseless_logical_distillation_meets_the_jax_bounds():
    """``test_logical_distillation_noiseless``'s bounds. The circuit keeps
    its ``DEPOLARIZE1(0.0)`` lines, so the program has f-bits, but every
    channel's no-fault outcome has probability 1: the f-bits stay 0."""
    sampler = models.logical_distillation_circuit(p=0.0, noise=0.0).compile_sampler(seed=0, device="cpu")
    assert sampler._noise.channels
    assert all(ch.probs[0] == 1.0 for ch in sampler._noise.channels)
    assert not sampler._device_channels.sample(sampler._generator, 64).any()
    out = sampler.sample(3000, batch_size=3000)
    assert out.shape == (3000, 5)
    sel = np.all(out[:, 1:] == np.array([1, 0, 1, 1]), axis=1)
    assert sel.mean() > 0.03
    assert out[sel, 0].mean() < 0.02


def test_port_builds_compiles_and_samples_without_jax_or_tsim_tpu():
    script = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = None  # any import of jax now raises
        sys.modules["tsim_tpu"] = None  # and any import of tsim_tpu
        import tsim_tpu_torch
        circuit = tsim_tpu_torch.distillation_d3(p=0.05)
        sampler = circuit.compile_detector_sampler(seed=0, device="cpu")
        out = sampler.sample(256, batch_size=128, append_observables=True)
        assert out.shape == (256, 20), out.shape
        assert sampler.compile_stats["decompose_s"] > 0, sampler.compile_stats
        assert not any(m == "jax" or m.startswith(("jax.", "tsim_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok", sampler.compile_stats["planner"])
        """
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    env.pop("TSIM_TPU_COMPILE_CACHE_DIR", None)
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, env=env, capture_output=True, text=True, timeout=600
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("ok ")


def test_compile_stats_and_dashboard_equal_tsim_tpu():
    text = str(models.distillation_d3(p=0.05))
    sampler = tsim_tpu_torch.Circuit(text).compile_detector_sampler(seed=0, device="cpu")
    stats = sampler.compile_stats
    assert set(stats) == {"prepare_s", "decompose_s", "channels_s", "planner"}
    assert stats["planner"] in ("native", "python")
    ref = tsim_tpu.Circuit(text).compile_detector_sampler(seed=0)
    assert repr(sampler) == repr(ref)
    assert repr(sampler).startswith("CompiledDetectorSampler(15 direct, 278 graphs")
    assert exported.distillation_d3().compile_detector_sampler(device="cpu").compile_stats is None


@pytest.mark.parametrize("sample_detectors", [False, True])
def test_compile_state_probs_sample_detectors(sample_detectors):
    text = "H 0 1\nT 0\nCNOT 0 1\nX_ERROR(0.1) 1\nT 1\nH 1\nM 0 1\nDETECTOR rec[-1]\nOBSERVABLE_INCLUDE(0) rec[-2]"
    sp = tsim_tpu_torch.Circuit(text).compile_state_probs(
        sample_detectors=sample_detectors, seed=0, device="cpu"
    )
    assert_same_leaves(
        tsim_tpu_torch.program_io.ExportedProgram(
            program=sp._program, noise=sp._noise, num_detectors=sp._num_detectors
        ),
        reference_compile(text, sample_detectors=sample_detectors, mode="joint"),
    )
    assert sp._program.num_outputs == 2
    assert sp.probability_of(np.array([0, 1], np.uint8), batch_size=64).shape == (64,)
    f = sp._device_channels.sample(sp._generator, 64)
    total = sum(sp._probability_body(f, np.array([a, b], np.uint8)) for a in (0, 1) for b in (0, 1))
    np.testing.assert_allclose(total.numpy(), 1.0, atol=1e-6)


def test_circuit_sampler_checkpoint_continues_stream(tmp_path):
    sampler = models.distillation_d3(p=0.05).compile_detector_sampler(seed=3, device="cpu")
    sampler.sample(512, batch_size=512)
    path = tmp_path / "d3.npz"
    sampler.save(path)
    restored = tsim_tpu_torch.CompiledDetectorSampler.load(path)
    np.testing.assert_array_equal(restored.sample(512, batch_size=256), sampler.sample(512, batch_size=256))
