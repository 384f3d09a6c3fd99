"""The port's detector error model against tsim_tpu's, text for text.

Mirrors ``tests/unit/noise/test_dem.py`` and ``test_dem_edge_cases.py``:
every circuit and keyword combination there, the surface codes d = 3 and 5
under both noise models of the repo's benchmarks (``bench_suite.py``: the
d7 panel's depolarizing model and BASELINE workload 2's Pauli channels), d3
distillation and 1-check cultivation give the same ``str`` on both sides,
and the same error where tsim_tpu raises one.
"""

import random

import numpy as np
import pytest

import tsim_tpu
import tsim_tpu_torch
from tests.helpers.gen import gen_circuit_text
from tsim_tpu.models import cultivation as ref_cultivation
from tsim_tpu.models import distillation as ref_distillation
from tsim_tpu.models import surface_code as ref_surface_code
from tsim_tpu.noise.dem import get_detector_error_model as ref_get_dem
from tsim_tpu.stim_core.dem import circuit_to_dem as ref_circuit_to_dem
from tsim_tpu_torch.models import cultivation, distillation, surface_code
from tsim_tpu_torch.noise.dem import get_detector_error_model
from tsim_tpu_torch.stim_core.dem import circuit_to_dem
from tsim_tpu_torch.stim_core.frame import FrameSampler

CLIFFORD = {
    "S": 1, "H": 2, "SQRT_X": 1, "SQRT_Y": 1, "CNOT": 2, "CZ": 1,
    "X": 1, "Z": 1, "Y": 1,
}
DEPOLARIZING = dict(after_clifford_depolarization=1e-3, before_measure_flip_probability=1e-3,
                    after_reset_flip_probability=1e-3)
P2 = 2e-3
PAULI_CHANNELS = dict(pauli_channel_1=(P2, P2 / 2, P2 / 2), pauli_channel_2=tuple([P2 / 15] * 15),
                      before_measure_flip_probability=P2)
KEYWORDS = ("allow_non_deterministic_observables", "decompose_errors", "flatten_loops",
            "allow_gauge_detectors", "approximate_disjoint_errors", "ignore_decomposition_failures",
            "block_decomposition_from_introducing_remnant_edges")


def _outcome(call):
    """The DEM's text, or the error's type and message."""
    try:
        return str(call())
    except Exception as e:  # the comparison is of what is raised
        return (type(e).__name__, str(e))


def _assert_same_dem(port_circuit, ref_circuit, **kw):
    got = _outcome(lambda: port_circuit.detector_error_model(**kw))
    assert got == _outcome(lambda: ref_circuit.detector_error_model(**kw))
    return got


def _texts(text):
    return tsim_tpu_torch.Circuit(text), tsim_tpu.Circuit(text)


# ---------------------------------------------------- the benchmark circuits
@pytest.mark.parametrize("d", [3, 5])
@pytest.mark.parametrize("noise", ["depolarizing", "pauli_channels"])
def test_surface_code_dem_equal(d, noise):
    kw = DEPOLARIZING if noise == "depolarizing" else PAULI_CHANNELS
    port = surface_code.rotated_surface_code_memory_z(d, d, **kw)
    ref = ref_surface_code.rotated_surface_code_memory_z(d, d, **kw)
    text = _assert_same_dem(port, ref, approximate_disjoint_errors=True)
    assert isinstance(text, str) and text.count("error(") > 100
    plain = _assert_same_dem(port, ref)
    if noise == "pauli_channels":  # PAULI_CHANNEL_2 needs the flag
        assert plain[0] == "ValueError" and "approximate_disjoint_errors" in plain[1]
    else:
        assert plain == text


def test_surface_code_dem_decomposed_equal():
    kw = dict(allow_non_deterministic_observables=False, decompose_errors=True)
    port = surface_code.rotated_surface_code_memory_z(3, 2, **DEPOLARIZING)
    ref = ref_surface_code.rotated_surface_code_memory_z(3, 2, **DEPOLARIZING)
    assert "^" in _assert_same_dem(port, ref, **kw)
    _assert_same_dem(port, ref, flatten_loops=True, **kw)


def test_distillation_and_cultivation_dem_equal():
    pairs = [
        (distillation.distillation_d3(p=0.05), ref_distillation.distillation_d3(p=0.05)),
        (cultivation.cultivation_d3(p=0.001, checks=1), ref_cultivation.cultivation_d3(p=0.001, checks=1)),
    ]
    for port, ref in pairs:
        for kw in ({}, {"approximate_disjoint_errors": True}, {"allow_gauge_detectors": True}):
            assert isinstance(_assert_same_dem(port, ref, **kw), str)


# ------------------------------------------------- the reference's circuits
EDGE_CASES = {
    "single_x": ("X_ERROR(0.25) 0\nM 0\nDETECTOR rec[-1]", {}),
    "depolarize": ("DEPOLARIZE1(0.3) 0\nM 0\nDETECTOR rec[-1]", {}),
    "correlated_chain": (
        "CORRELATED_ERROR(0.125) X0\nELSE_CORRELATED_ERROR(0.25) X1\nM 0 1\nDETECTOR rec[-2]\nDETECTOR rec[-1]",
        {"approximate_disjoint_errors": True},
    ),
    "noiseless": ("H 0\nCNOT 0 1\nM 0 1\nDETECTOR rec[-1] rec[-2]", {}),
    "mpp": ("MPP(0.2) X0*X1\nMPP X0*X1\nDETECTOR rec[-1] rec[-2]", {}),
    "mpad": ("X_ERROR(0.25) 0\nMPAD 0\nM 0\nDETECTOR rec[-1] rec[-2]", {}),
    "noisy_mzz": ("R 0 1\nMZZ(0.125) 0 1\nMZZ 0 1\nDETECTOR rec[-1] rec[-2]", {}),
    "heralded_erase": (
        "R 0\nHERALDED_ERASE(0.2) 0\nDETECTOR rec[-1]\nM 0\nDETECTOR rec[-1]",
        {"approximate_disjoint_errors": True},
    ),
    "heralded_pauli": (
        "R 0\nHERALDED_PAULI_CHANNEL_1(0.05, 0.1, 0.0, 0.05) 0\nDETECTOR rec[-1]\nM 0\nDETECTOR rec[-1]",
        {"approximate_disjoint_errors": True},
    ),
    "observable_error": ("X_ERROR(0.125) 0\nM 0\nOBSERVABLE_INCLUDE(0) rec[-1]", {}),
    "non_deterministic_observable": ("H 0\nM 0\nOBSERVABLE_INCLUDE(0) rec[-1]", {}),
    "observable_count": (
        "X_ERROR(0.1) 0\nM 0 0\nOBSERVABLE_INCLUDE(2) rec[-1]\nDETECTOR rec[-1] rec[-2]", {}
    ),
    "gauge_observable_decomposed": ("H 0\nM 0\nOBSERVABLE_INCLUDE(0) rec[-1]", {"decompose_errors": True}),
    "gauge_detector": ("H 0\nM 0\nDETECTOR rec[-1]", {}),
    "bell_observable": (
        "R 0 1\nH 0\nCNOT 0 1\nX_ERROR(0.1) 0\nM 0 1\nDETECTOR rec[-1] rec[-2]\nOBSERVABLE_INCLUDE(0) rec[-1]",
        {},
    ),
    "disjoint_channel": ("R 0\nPAULI_CHANNEL_1(0.1, 0.2, 0) 0\nM 0\nDETECTOR rec[-1]", {}),
    "disjoint_channel_flag": (
        "R 0\nPAULI_CHANNEL_1(0.1, 0.2, 0) 0\nM 0\nDETECTOR rec[-1]", {"approximate_disjoint_errors": True}
    ),
    "decompose_with_non_deterministic": ("X_ERROR(0.1) 0\nM 0\nDETECTOR rec[-1]", {"decompose_errors": True}),
    "repeat_flattened": (
        "R 0 1\nREPEAT 3 {\nX_ERROR(0.1) 0\nCNOT 0 1\nM 1\nDETECTOR rec[-1]\n}\nM 0\nOBSERVABLE_INCLUDE(0) rec[-1]",
        {"flatten_loops": True},
    ),
}


@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_edge_case_dem_equal(name):
    text, kw = EDGE_CASES[name]
    _assert_same_dem(*_texts(text), **kw)


DECOMPOSE_CASES = {
    "three_detectors": "E(0.1) X0 X1 X2\nM 0 1 2\nDETECTOR rec[-3]\nDETECTOR rec[-2]\nDETECTOR rec[-1]",
    "remnant_edge": (
        "E(0.1) X0 X1 X2\nX_ERROR(0.05) 0\nM 0 1 2\nDETECTOR rec[-3]\nDETECTOR rec[-2]\nDETECTOR rec[-1]"
    ),
}


@pytest.mark.parametrize("name", sorted(DECOMPOSE_CASES))
@pytest.mark.parametrize("flags", [(), ("ignore_decomposition_failures",),
                                   ("block_decomposition_from_introducing_remnant_edges",)])
def test_decomposition_dem_equal_and_raises_alike(name, flags):
    port, ref = _texts(DECOMPOSE_CASES[name])
    kw = dict(allow_non_deterministic_observables=False, decompose_errors=True, **{f: True for f in flags})
    got = _outcome(lambda: get_detector_error_model(port.cast_to_stim(), **kw))
    assert got == _outcome(lambda: ref_get_dem(ref.cast_to_stim(), **kw))
    assert got == _outcome(lambda: port.detector_error_model(**kw))


def test_circuit_to_dem_errors_alike():
    for text, kw in (("R 0\nH 0\nM 0\nDETECTOR rec[-1]", {}),
                     ("R 0\nH 0\nM 0\nDETECTOR rec[-1]", {"allow_gauge_detectors": True}),
                     ("R 0\nPAULI_CHANNEL_1(0.1, 0.2, 0) 0\nM 0\nDETECTOR rec[-1]", {})):
        port, ref = _texts(text)
        got = _outcome(lambda: circuit_to_dem(port._stim_circ, **kw))
        assert got == _outcome(lambda: ref_circuit_to_dem(ref._stim_circ, **kw))
    assert got[0] == "ValueError" and "disjoint" in got[1]


@pytest.mark.parametrize("batch", range(2))
def test_random_single_mechanism_dem_equal(batch):
    """The random single-error circuits of test_dem.py's exactness test."""
    rng = random.Random(batch)
    for trial in range(10):
        text = gen_circuit_text(3, 15, include_measurements=False, gate_weights=CLIFFORD, seed=batch * 15 + trial)
        lines = text.splitlines()
        pos = rng.randrange(1, len(lines) + 1)
        err = f"{rng.choice(['X_ERROR(1)', 'Z_ERROR(1)', 'Y_ERROR(0.3)'])} {rng.randrange(3)}"
        if rng.random() < 0.5:
            lines.insert(rng.randrange(1, len(lines)), f"{rng.choice(['MR', 'M', 'MX', 'MRX'])} {rng.randrange(3)}")
        lines.insert(pos, err)
        lines += ["MZZ 0 1 1 2", "MX 0", "DETECTOR rec[-3]", "DETECTOR rec[-2]", "DETECTOR rec[-1]"]
        port, ref = _texts("\n".join(lines))
        got = _outcome(lambda: circuit_to_dem(port._stim_circ, allow_gauge_detectors=True))
        assert got == _outcome(lambda: ref_circuit_to_dem(ref._stim_circ, allow_gauge_detectors=True))


def _dem_first_order_rates(dem):
    rates = np.zeros(dem.num_detectors)
    for ins in dem:
        if ins.type == "error":
            p = ins.args[0]
            for t in ins.targets:
                if t.kind == "D":
                    rates[t.val] = rates[t.val] + p - 2 * rates[t.val] * p
    return rates


def test_surface_code_dem_rates_match_frame_sampler():
    c = surface_code.rotated_surface_code_memory_z(
        3, 2, after_clifford_depolarization=0.03, before_measure_flip_probability=0.02
    )
    _, d, _ = FrameSampler(c._stim_circ, seed=0).sample(50000)
    rates = _dem_first_order_rates(c.detector_error_model(approximate_disjoint_errors=True))
    assert np.abs(rates - d.mean(axis=0)).max() < 0.006


def test_circuit_keywords_match_tsim_tpu():
    import inspect

    port = inspect.signature(tsim_tpu_torch.Circuit.detector_error_model).parameters
    ref = inspect.signature(tsim_tpu.Circuit.detector_error_model).parameters
    assert tuple(port)[1:] == KEYWORDS == tuple(ref)[1:]
    assert all(port[k].default == ref[k].default for k in KEYWORDS)


def test_committed_surface_d7_reproduced():
    """What chip_smoke.py's phase 21 checks on the card's host: the port
    compiles bench_suite.py's d7 panel to the committed fully-direct program
    leaf for leaf, and its DEM text hashes to tsim_tpu's."""
    import hashlib

    from tsim_tpu_torch import program_io
    from tsim_tpu_torch.models.exported import SURFACE_D7_PROGRAM
    from tsim_tpu_torch.sampler import compile_circuit

    committed = program_io.load_npz(SURFACE_D7_PROGRAM)
    circuit = surface_code.rotated_surface_code_memory_z(
        7, 7, after_clifford_depolarization=0.001, before_measure_flip_probability=0.001,
        after_reset_flip_probability=0.001,
    )
    got, _stats = compile_circuit(circuit, sample_detectors=True, mode="sequential")
    assert not got.program.components
    assert program_io.leaf_differences(got, committed) == []
    text = str(circuit.detector_error_model())
    assert hashlib.sha256(text.encode()).hexdigest() == committed.meta["dem_sha256"]
    assert len(text.splitlines()) == committed.meta["dem_lines"]
