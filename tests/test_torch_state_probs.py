"""The port's CompiledStateProbs against the statevector simulator and tsim_tpu.

* Every outcome of a few noiseless 3-qubit circuits of
  ``tests/integration/test_state_probs.py`` (Clifford+T, with rotations, and
  the distillation-style circuit), compiled by tsim_tpu and evaluated by the
  port, against ``VecSampler`` (atol 1e-6, as that file holds tsim_tpu).
* d3 distillation's estimator on 512 noise rows drawn by tsim_tpu's channel
  sampler, against tsim_tpu's ``_probability_body``. rtol 5e-6: the joint
  rung sums approximate floatfactors in f32 in another order (about 1e-6),
  and tsim_tpu scales by XLA's CPU ``exp2``, which misses some integer
  powers of two by up to 4e-6 (``test_torch_exact_eval.py``).
* The committed replay (4096 rows, 4 states) on the CPU, with the same
  tolerance; ``chip_smoke.py`` checks it on the card.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tsim_tpu
from tsim_tpu.external.vec_sim.vec_sampler import VecSampler
from dev.export_torch_program import compile_d3_state_probs, export_sampler
from tests.helpers.gen import gen_circuit_text
from tests.integration.test_state_probs import CLIFFORD_T, WITH_ROTATIONS
from tsim_tpu_torch.kernels import exact_eval as kernel
from tsim_tpu_torch.models.exported import distillation_d3
from tsim_tpu_torch.sampler import CompiledStateProbs

RTOL = 5e-6

_THETA = -float(np.arccos(np.sqrt(1 / 3)) / np.pi)
_SMALL = {
    "clifford_t_0": gen_circuit_text(3, 25, gate_weights=CLIFFORD_T, seed=0),
    "clifford_t_1": gen_circuit_text(3, 25, gate_weights=CLIFFORD_T, seed=1),
    "rotations_4": gen_circuit_text(3, 20, gate_weights=WITH_ROTATIONS, seed=4),
    "distillation_style": f"""
        R 0 1
        R_X({_THETA}) 0 1
        T_DAG 0 1
        CZ 0 1
        SQRT_X 0
        T 0
        R_X({-_THETA}) 0
        M 0 1
    """,
}


@pytest.mark.parametrize("name", sorted(_SMALL))
def test_small_circuits_match_statevector(name):
    circuit = tsim_tpu.Circuit(_SMALL[name])
    port = CompiledStateProbs(
        export_sampler(circuit.compile_state_probs(seed=0)), seed=0, device="cpu"
    )
    oracle = VecSampler(circuit, seed=0)
    kernel.reset_launch_counts()
    for bits in itertools.product([0, 1], repeat=circuit.num_measurements):
        got = port.probability_of(np.array(bits), batch_size=1)
        assert got.shape == (1,) and got.dtype == np.float32
        assert abs(float(got[0]) - oracle.probability_of(bits)) < 1e-6, bits
    assert kernel.launch_counts == dict.fromkeys(kernel.launch_counts, 0)


@pytest.fixture(scope="module")
def d3_state_probs():
    """(tsim_tpu's estimator, the port's estimator on the CPU)."""
    reference = compile_d3_state_probs()
    return reference, CompiledStateProbs(export_sampler(reference), seed=0, device="cpu")


def test_d3_matches_tsim_tpu_on_injected_noise(d3_state_probs):
    reference, port = d3_state_probs
    f = np.asarray(reference._channel_sampler.sample(512), np.uint8)
    states = distillation_d3(p=0.05).load_state_probs().replay["states"]
    nonzero = 0
    for state in states:
        want = np.asarray(reference._probability_body(jnp.asarray(f), state))
        got = port._probability_body(torch.from_numpy(f), state).numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
        nonzero += int((want > 0).sum())
    assert nonzero > 100


def test_committed_replay_matches():
    """The port reproduces the probabilities tsim_tpu computed for the
    committed noise rows and states."""
    circuit = distillation_d3(p=0.05)
    replay = circuit.load_state_probs().replay
    port = circuit.compile_state_probs(seed=0, device="cpu")
    f = torch.from_numpy(replay["f"])
    for state, want in zip(replay["states"], replay["probabilities"]):
        got = port._probability_body(f, state).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def test_probability_of_draws_noise_from_the_generator():
    circuit = distillation_d3(p=0.05)
    state = circuit.load_state_probs().replay["states"][1]
    a = circuit.compile_state_probs(seed=3, device="cpu").probability_of(state, batch_size=300)
    b = circuit.compile_state_probs(seed=3, device="cpu").probability_of(state, batch_size=300)
    assert a.shape == (300,) and a.dtype == np.float32
    assert np.isfinite(a).all() and (a >= 0).all() and (a <= 1).all() and (a > 0).any()
    np.testing.assert_array_equal(a, b)


def test_probability_of_errors(d3_state_probs):
    _, port = d3_state_probs
    with pytest.raises(ValueError, match="batch_size"):
        port.probability_of(np.zeros(35, np.uint8), batch_size=0)
    with pytest.raises(ValueError, match="shape"):
        port.probability_of(np.zeros(34, np.uint8), batch_size=4)
    with pytest.raises(ValueError, match="two rungs"):
        CompiledStateProbs(distillation_d3(p=0.05).load(), device="cpu")
