"""The port's Clifford frame layer against tsim_tpu's, bit for bit.

Mirrors ``tests/unit/stim_core/test_tableau_frame.py`` and
``test_native_frame.py`` and the m2d cases of ``tests/unit/test_circuit_api.py``:
the tableau's reference sample, the Python ``FrameSampler``, the C++
``NativeFrameSampler`` (both packages build ``frame_kernels.cpp`` with the
same flags on this host, so the same seed gives the same bits), the
measurement-to-detection converter and the statevector oracle
(``VecSampler``) take the same circuits, from ``tests/helpers/gen.py`` and
the reference's own, on both sides and must agree exactly.
"""

import numpy as np
import pytest

import tsim_tpu
import tsim_tpu_torch
from tests.helpers.gen import gen_circuit_text
from tsim_tpu.external.vec_sim.vec_sampler import VecSampler as RefVecSampler
from tsim_tpu.models.surface_code import rotated_surface_code_memory_z as ref_surface_code
from tsim_tpu.stim_core.frame import FrameSampler as RefFrameSampler
from tsim_tpu.stim_core.frame import reference_sample as ref_reference_sample
from tsim_tpu.stim_core.native_frame import NativeFrameSampler as RefNativeFrameSampler
from tsim_tpu_torch.external.vec_sim.vec_sampler import VecSampler
from tsim_tpu_torch.models.surface_code import rotated_surface_code_memory_z
from tsim_tpu_torch.stim_core.frame import FrameSampler, reference_sample
from tsim_tpu_torch.stim_core.native_frame import NativeFrameSampler
from tsim_tpu_torch.stim_core.tableau import TableauSimulator

CLIFFORD = {
    "S": 1, "H": 2, "SQRT_X": 1, "SQRT_Y": 1, "CNOT": 2, "CZ": 1,
    "X": 1, "Z": 1, "Y": 1,
}
NOISY_CLIFFORD = dict(CLIFFORD, **{"X_ERROR(0.4)": 1, "DEPOLARIZE1(0.4)": 1,
                                   "DEPOLARIZE2(0.5)": 1, "PAULI_CHANNEL_1(0.3, 0.2, 0.1)": 1})

# The circuits of tests/unit/stim_core/test_native_frame.py, and the
# heralded mid-circuit one of test_tableau_frame.py.
NATIVE_CASES = {
    "bell": "H 0\nCNOT 0 1\nX_ERROR(0.25) 0\nM 0 1\nDETECTOR rec[-1] rec[-2]\nOBSERVABLE_INCLUDE(0) rec[-1]",
    "random": "H 0\nM 0",
    "bases": "RX 0\nRY 1\nH 2\nS 2\nMX 0\nMY 1\nMZ 2\nMRX 0\nMRY 1\nMR 2\nMX 0\nMY 1\nM 2",
    "channels": (
        "DEPOLARIZE1(0.3) 0\nDEPOLARIZE2(0.3) 1 2\nPAULI_CHANNEL_1(0.1, 0.15, 0.2) 3\n"
        "PAULI_CHANNEL_2(0.02,0.02,0.02,0.02,0.02,0.02,0.02,0.02,0.02,0.02,0.02,0.02,0.02,0.02,0.02) 0 3\n"
        "X_ERROR(0.2) 1\nY_ERROR(0.2) 2\nZ_ERROR(0.3) 2\nH 2\nM 0 1 2 3"
    ),
    "heralded_correlated": (
        "HERALDED_ERASE(0.4) 0\nHERALDED_PAULI_CHANNEL_1(0.1,0.1,0.1,0.1) 1\n"
        "CORRELATED_ERROR(0.3) X0 Z1\nELSE_CORRELATED_ERROR(0.4) Y1\nM 0 1\nDETECTOR rec[-1]"
    ),
    "products": "H 0\nCNOT 0 1\nMZZ 0 1\nMXX 0 1\nMPP X0*X1 Z0*Z1\nDETECTOR rec[-4] rec[-2]",
    "rec_controlled_mpad": "H 0\nM 0\nCX rec[-1] 1\nM 1\nMPAD 0 1\nDETECTOR rec[-3] rec[-4]",
    "inverted_repeat": "X 0\nREPEAT 3 {\nCNOT 0 1\nX_ERROR(0.1) 1\nM 1\n}\nM !0\nDETECTOR rec[-2] rec[-3]",
    "mid_circuit_herald": (
        "RX 0\nMR 0\nHERALDED_ERASE(0.3) 1\nCX rec[-1] 1\nM 0 1\nDETECTOR rec[-1]\n"
        "OBSERVABLE_INCLUDE(0) rec[-2]"
    ),
}
SURFACE = dict(after_clifford_depolarization=0.02, before_measure_flip_probability=0.01,
               after_reset_flip_probability=0.01)


def _pair(text):
    """(the port's stim circuit, tsim_tpu's) of ``text``."""
    return tsim_tpu_torch.Circuit(text)._stim_circ, tsim_tpu.Circuit(text)._stim_circ


def _surface_pair(d=3, rounds=3):
    port = rotated_surface_code_memory_z(d, rounds, **SURFACE)
    ref = ref_surface_code(d, rounds, **SURFACE)
    assert str(port) == str(ref)
    return port._stim_circ, ref._stim_circ


def _assert_all_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# ----------------------------------------------------- tableau and frame
@pytest.mark.parametrize("seed", range(6))
def test_reference_sample_equal_and_possible(seed):
    text = gen_circuit_text(4, 30, gate_weights=CLIFFORD, seed=seed)
    port, ref = _pair(text)
    got = reference_sample(port)
    np.testing.assert_array_equal(got, ref_reference_sample(ref))
    assert VecSampler(tsim_tpu_torch.Circuit(text), seed=0).probability_of(got.astype(int)) > 1e-9


@pytest.mark.parametrize("seed", range(3))
def test_frame_sampler_equal_on_noisy_random_circuits(seed):
    text = gen_circuit_text(4, 40, gate_weights=NOISY_CLIFFORD, seed=seed)
    port, ref = _pair(text)
    _assert_all_equal(FrameSampler(port, seed=seed).sample(300), RefFrameSampler(ref, seed=seed).sample(300))


@pytest.mark.parametrize("name", sorted(NATIVE_CASES))
def test_frame_sampler_equal_on_reference_cases(name):
    port, ref = _pair(NATIVE_CASES[name])
    _assert_all_equal(FrameSampler(port, seed=3).sample(500), RefFrameSampler(ref, seed=3).sample(500))


def test_frame_sampler_equal_on_surface_code():
    port, ref = _surface_pair()
    _assert_all_equal(FrameSampler(port, seed=1).sample(200), RefFrameSampler(ref, seed=1).sample(200))


def test_tableau_measurements_equal():
    """The tableau's random measurement outcomes, at the same generator seed."""
    from tsim_tpu.stim_core.tableau import TableauSimulator as RefTableauSimulator

    ops = [("H", [0]), ("CNOT", [0, 1]), ("S", [1]), ("SQRT_X", [2]), ("CZ", [1, 2]), ("H", [3]),
           ("CNOT", [3, 0]), ("SQRT_Y", [1]), ("ISWAP", [2, 3])]
    for seed in range(4):
        a = TableauSimulator(4, np.random.default_rng(seed))
        b = RefTableauSimulator(4, np.random.default_rng(seed))
        for name, qubits in ops:
            a.apply_gate(name, qubits)
            b.apply_gate(name, qubits)
        assert [a.measure(q) for q in range(4)] == [b.measure(q) for q in range(4)]
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.z, b.z)


# ----------------------------------------------------------- native engine
@pytest.mark.parametrize("bit_packed", [False, True])
@pytest.mark.parametrize("name", sorted(NATIVE_CASES))
def test_native_frame_equal(name, bit_packed):
    port, ref = _pair(NATIVE_CASES[name])
    a, b = NativeFrameSampler(port, seed=9), RefNativeFrameSampler(ref, seed=9)
    for shots in (1000, 77):  # two calls: the engine's seed stream advances alike
        _assert_all_equal(a.sample(shots, bit_packed=bit_packed), b.sample(shots, bit_packed=bit_packed))


@pytest.mark.parametrize("shots", [1, 63, 64, 65, 130])
def test_native_frame_non_multiple_word_shots(shots):
    port, ref = _pair("X 0\nX_ERROR(0.3) 1\nM 0 1\nDETECTOR rec[-1]")
    got = NativeFrameSampler(port, seed=0).sample(shots)
    _assert_all_equal(got, RefNativeFrameSampler(ref, seed=0).sample(shots))
    assert got[0].shape == (shots, 2) and got[0][:, 0].all()
    packed = NativeFrameSampler(port, seed=0).sample(shots, bit_packed=True)
    _assert_all_equal(packed, RefNativeFrameSampler(ref, seed=0).sample(shots, bit_packed=True))


def test_native_frame_equal_on_surface_code_with_det_bias():
    port, ref = _surface_pair()
    bias = np.zeros(port.num_detectors, np.uint8)
    bias[::3] = 1
    a = NativeFrameSampler(port, seed=4, det_bias=bias)
    b = RefNativeFrameSampler(ref, seed=4, det_bias=bias)
    _assert_all_equal(a.sample(2000), b.sample(2000))
    np.testing.assert_array_equal(a.sample_det_obs_joined(999), b.sample_det_obs_joined(999))


def test_native_frame_bit_packed_and_measurement_free_layouts():
    port, _ref = _pair("X 0\nM 0 1")
    m, _, _ = NativeFrameSampler(port, seed=0).sample(70, bit_packed=True)
    assert m.shape == (70, 1) and (m == 1).all()  # bit0 set, bit1 clear
    m, d, o = NativeFrameSampler(port, seed=0).sample(70, include_measurements=False)
    assert m is None and d.shape == (70, 0) and o.shape == (70, 0)


def test_native_frame_random_measurement_is_uniform():
    port, _ref = _pair("H 0\nM 0")
    m, _, _ = NativeFrameSampler(port, seed=0).sample(40000)
    assert abs(m.mean() - 0.5) < 0.01


# --------------------------------------------------------------------- m2d
def test_m2d_outputs_equal():
    port, ref = _surface_pair(3, 2)
    m, _, _ = RefFrameSampler(ref, seed=0).sample(500)
    for skip in (False, True):
        a = tsim_tpu_torch.Circuit(str(port)).compile_m2d_converter(skip_reference_sample=skip)
        b = tsim_tpu.Circuit(str(ref)).compile_m2d_converter(skip_reference_sample=skip)
        for kw in ({}, {"separate_observables": True}, {"append_observables": True}):
            got, want = a.convert(measurements=m, **kw), b.convert(measurements=m, **kw)
            _assert_all_equal(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,))


def test_m2d_of_native_records_equals_its_detectors():
    port, _ = _surface_pair(5, 3)
    m, d, o = NativeFrameSampler(port, seed=2).sample(3000)
    dets, obs = tsim_tpu_torch.Circuit(str(port)).compile_m2d_converter().convert(
        measurements=m, separate_observables=True
    )
    np.testing.assert_array_equal(dets, d)
    np.testing.assert_array_equal(obs, o)
    assert d.any()  # the noise fired: the comparison is not between zeros


def test_m2d_converts_and_folds_baseline():
    conv = tsim_tpu_torch.Circuit(
        "X_ERROR(0.5) 0\nM 0 1\nDETECTOR rec[-2]\nOBSERVABLE_INCLUDE(0) rec[-1]"
    ).compile_m2d_converter()
    m = np.array([[1, 0], [0, 0], [0, 1]], dtype=np.bool_)
    dets, obs = conv.convert(measurements=m, separate_observables=True)
    np.testing.assert_array_equal(dets[:, 0], [True, False, False])
    np.testing.assert_array_equal(obs[:, 0], [False, False, True])
    conv = tsim_tpu_torch.Circuit("X 0\nM 0\nDETECTOR rec[-1]").compile_m2d_converter()
    assert conv.convert(measurements=np.zeros((1, 1), np.bool_))[0, 0]
    with pytest.raises(ValueError, match="shape"):
        conv.convert(measurements=np.zeros((1, 2), np.bool_))


# ------------------------------------------------------ statevector oracle
ORACLE_TEXT = """
R 0 1 2
H 0
T 0
CNOT 0 1
R_Z(0.3) 1
U3(0.34, 0.21, 0.46) 2
CZ 1 2
T_DAG 2
H 1
M 0 1 2
"""


@pytest.mark.parametrize("seed", range(3))
def test_vec_sampler_probabilities_equal(seed):
    weights = {"T": 1, "H": 2, "S": 1, "CNOT": 2, "R_Z(0.33)": 1, "U3(0.34, 0.21, 0.46)": 1}
    text = gen_circuit_text(3, 20, gate_weights=weights, seed=seed)
    a, b = VecSampler(tsim_tpu_torch.Circuit(text), seed=0), RefVecSampler(tsim_tpu.Circuit(text), seed=0)
    for k in range(8):
        bits = [(k >> i) & 1 for i in range(3)]
        assert a.probability_of(bits) == b.probability_of(bits)
    np.testing.assert_array_equal(a.final_state(), b.final_state())


def test_vec_sampler_shots_equal_with_noise():
    text = ORACLE_TEXT.replace("H 1\n", "H 1\nDEPOLARIZE1(0.2) 0 1\nX_ERROR(0.1) 2\n") + "DETECTOR rec[-1] rec[-2]\n"
    a, b = VecSampler(tsim_tpu_torch.Circuit(text), seed=5), RefVecSampler(tsim_tpu.Circuit(text), seed=5)
    _assert_all_equal(a.sample(64), b.sample(64))


STATE_PROBS_TEXT = """
R 0 1 2 3 4
H 0 1 2 3 4
T 0
CNOT 0 1
R_Z(0.3) 1
U3(0.34, 0.21, 0.46) 2
CZ 1 2
T_DAG 3
CNOT 3 4
R_Z(0.7) 4
H 0 2
T 1
CNOT 2 3
U3(0.1, 0.5, 0.25) 0
M 0 1 2 3 4
"""


def test_state_probs_match_the_statevector_oracle():
    """The port's exact state probabilities against its own statevector
    oracle, on every outcome of chip_smoke.py phase 22's kind of circuit."""
    c = tsim_tpu_torch.Circuit(STATE_PROBS_TEXT)
    sp = c.compile_state_probs(seed=0, device="cpu")
    oracle = VecSampler(c, seed=0)
    total = 0.0
    for k in range(32):
        bits = np.array([(k >> i) & 1 for i in range(5)], np.uint8)
        want = oracle.probability_of(bits)
        np.testing.assert_allclose(sp.probability_of(bits, batch_size=3), want, rtol=0, atol=1e-6)
        total += want
    assert abs(total - 1) < 1e-9
