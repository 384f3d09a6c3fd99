"""The port's ``Circuit`` and model builders against tsim_tpu's, on the CPU (stage a).

For every model builder at every argument tsim_tpu's tests and benchmarks
use, a few seeded random circuits of ``tests/helpers/gen.py`` (T, R_Z, U3,
R_PAULI, CCZ and the noise channels), and the ``Circuit`` arithmetic
(``+``, ``*``, slicing, ``inverse``, ``without_noise`` and the rest of the
structural surface), the text and the counters of the port's circuit equal
tsim_tpu's. Stage d's surface (the detector error model, the
measurement-to-detection converter and the diagram) raises what tsim_tpu
raises on bad input; what it returns is held to tsim_tpu's in
``test_torch_dem.py``, ``test_torch_frame.py`` and
``test_torch_clifford_and_encoder.py``.
"""

from __future__ import annotations

import numpy as np
import pytest

import tsim_tpu
import tsim_tpu.models.cultivation as jax_cultivation
import tsim_tpu.models.distillation as jax_distillation
import tsim_tpu.models.surface_code as jax_surface_code
import tsim_tpu_torch
from tests.helpers.gen import gen_circuit_text
from tsim_tpu_torch import models

COUNTERS = ("num_qubits", "num_detectors", "num_observables", "num_measurements", "num_ticks")

# (builder, keyword arguments): every argument of the JAX tests
# (tests/unit, tests/integration) and of bench_suite.py's panels and sweeps.
MODEL_CASES = [
    ("logical_distillation_circuit", {}),
    ("logical_distillation_circuit", {"p": 0.0, "noise": 0.0}),
    ("logical_distillation_circuit", {"p": 0.05, "noise": 0.0}),
    *[("distillation_d3", {"p": p}) for p in (0.05, 0.02, 0.01, 0.001)],
    ("distillation_d3", {"p": 0.05, "basis": "X"}),
    ("distillation_d3", {"p": 0.05, "basis": "Y", "noise": 0.0}),
    *[("distillation_d5", {"p": p}) for p in (0.0, 0.02, 0.04, 0.05)],
    ("cultivation_logical", {"p": 0.0, "checks": 2, "noise": 0.0}),
    ("cultivation_logical", {"p": 0.02, "checks": 1, "noise": 0.002}),
    *[("cultivation_d3", {"p": p}) for p in (0.001, 0.002, 0.0005)],
    ("cultivation_d3", {"p": 0.001, "checks": 2}),
    ("cultivation_d3", {"p": 0.0, "checks": 1, "stabilizer_rounds": 1, "noise": 0.0}),
    ("cultivation_d3_grown", {"p": 0.001, "checks": 2}),
    ("cultivation_d3_grown", {"p": 0.0, "checks": 1, "noise": 0.0}),
    ("cultivation_d3_grown", {"p": 0.0, "checks": 2, "noise": 0.0}),
    ("rotated_surface_code_memory_z", {"distance": 3, "rounds": 2, "after_clifford_depolarization": 0.02}),
    ("rotated_surface_code_memory_z", {
        "distance": 3, "rounds": 2, "after_clifford_depolarization": 0.02,
        "before_measure_flip_probability": 0.02,
    }),
    ("rotated_surface_code_memory_z", {
        "distance": 3, "rounds": 3, "after_clifford_depolarization": 0.01,
        "before_round_data_depolarization": 0.01, "before_measure_flip_probability": 0.01,
        "after_reset_flip_probability": 0.01,
    }),
    ("rotated_surface_code_memory_z", {
        "distance": 5, "rounds": 5, "after_clifford_depolarization": 0.005,
        "before_round_data_depolarization": 0.005, "before_measure_flip_probability": 0.005,
        "after_reset_flip_probability": 0.005,
    }),
    ("rotated_surface_code_memory_z", {
        "distance": 5, "rounds": 3, "pauli_channel_1": (0.004, 0.002, 0.002),
        "pauli_channel_2": tuple([0.004 / 15] * 15), "before_measure_flip_probability": 0.004,
    }),
    ("generated", {"name": "surface_code:rotated_memory_x", "distance": 3, "rounds": 2}),
    ("generated", {
        "name": "surface_code:rotated_memory_x", "distance": 3, "rounds": 2,
        "after_clifford_depolarization": 0.01,
    }),
    ("generated", {"name": "surface_code:rotated_memory_z", "distance": 7, "rounds": 7,
                   "after_clifford_depolarization": 0.001}),
]
JAX_BUILDERS = {
    name: getattr(module, name)
    for module in (jax_distillation, jax_cultivation, jax_surface_code)
    for name in dir(module)
    if not name.startswith("_")
}

RANDOM_WEIGHTS = {
    "T": 2, "H": 2, "CNOT": 2, "S": 1, "SQRT_X": 1, "R_Z(0.33)": 1, "R_X(0.31)": 1,
    "U3(0.34, 0.21, 0.46)": 1, "R_PAULI2": 1, "TPP2": 1, "X_ERROR(0.4)": 1,
    "DEPOLARIZE1(0.4)": 1, "DEPOLARIZE2(0.5)": 1, "PAULI_CHANNEL_1(0.3, 0.2, 0.1)": 1,
}


def random_text(seed: int) -> str:
    text = gen_circuit_text(5, 30, gate_weights=RANDOM_WEIGHTS, seed=seed)
    return "CCZ 0 1 2\nCCX 2 3 4\n" + text + "\nDETECTOR rec[-1] rec[-2]\nOBSERVABLE_INCLUDE(0) rec[-3]"


def _case_id(case) -> str:
    name, kwargs = case
    return name + "-" + "-".join(f"{k}={v}" for k, v in kwargs.items() if k != "pauli_channel_2")


def _assert_same(port, ref) -> None:
    assert str(port) == str(ref)
    for attr in COUNTERS:
        assert getattr(port, attr) == getattr(ref, attr), attr
    assert len(port) == len(ref)


@pytest.mark.parametrize("case", MODEL_CASES, ids=_case_id)
def test_model_builders_equal_tsim_tpu(case):
    name, kwargs = case
    port = getattr(models, name)(**kwargs)
    assert isinstance(port, tsim_tpu_torch.Circuit)
    _assert_same(port, JAX_BUILDERS[name](**kwargs))


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_random_circuits_equal_tsim_tpu(seed):
    text = random_text(seed)
    port, ref = tsim_tpu_torch.Circuit(text), tsim_tpu.Circuit(text)
    _assert_same(port, ref)
    assert repr(port) == repr(ref).replace("tsim_tpu.Circuit", "tsim_tpu_torch.Circuit", 1)
    assert port.is_clifford == ref.is_clifford
    assert port.tcount() == ref.tcount()
    assert str(port.stim_circuit) == str(ref.stim_circuit)
    assert str(port.cast_to_stim()) == str(ref.cast_to_stim())


def test_unitaries_equal_tsim_tpu():
    text = "H 0\nT 0\nCNOT 0 1\nR_Z(0.33) 1\nU3(0.34, 0.21, 0.46) 0\nCCZ 0 1 2\nR_PAULI(0.27) X0*Z2"
    port, ref = tsim_tpu_torch.Circuit(text), tsim_tpu.Circuit(text)
    np.testing.assert_array_equal(port.to_matrix(), ref.to_matrix())
    np.testing.assert_array_equal(port.to_tensor(), ref.to_tensor())


def _pair(text: str):
    return tsim_tpu_torch.Circuit(text), tsim_tpu.Circuit(text)


ARITHMETIC = {
    "add": lambda a, b: a + b,
    "iadd": lambda a, b: _iadd(a, b),
    "mul": lambda a, _: a * 3,
    "rmul": lambda a, _: 2 * a,
    "imul": lambda a, _: _imul(a),
    "slice": lambda a, _: a[1:6],
    "slice_step": lambda a, _: a[::2],
    "inverse": lambda a, _: _unitary_part(a).inverse(),
    "without_noise": lambda a, _: a.without_noise(),
    "without_annotations": lambda a, _: a.without_annotations(),
    "flattened": lambda a, _: (a * 2).flattened(),
    "copy": lambda a, _: a.copy(),
}


def _unitary_part(c):
    """``c`` without resets, measurements, noise and annotations, which have
    no inverse."""
    kept = type(c)()
    for instr in c.without_noise().without_annotations():
        if instr.name not in ("R", "M"):
            kept.append(instr)
    return kept


def _iadd(a, b):
    a = a.copy()
    a += b
    return a


def _imul(a):
    a = a.copy()
    a *= 2
    return a


@pytest.mark.parametrize("op", sorted(ARITHMETIC))
@pytest.mark.parametrize("seed", [1, 3])
def test_circuit_arithmetic_equals_tsim_tpu(op, seed):
    a, ra = _pair(random_text(seed))
    b, rb = _pair(random_text(seed + 10))
    _assert_same(ARITHMETIC[op](a, b), ARITHMETIC[op](ra, rb))


def test_append_api_equals_tsim_tpu():
    port, ref = tsim_tpu_torch.Circuit(), tsim_tpu.Circuit()
    for c in (port, ref):
        c.append("H", [0, 1, 2])
        c.append("T", [0])
        c.append("R_Z", [1], 0.25)
        c.append("U3", [2], [0.1, 0.2, 0.3])
        c.append("R_XX", [0, 1], 0.3)
        c.append("CCZ", [0, 1, 2])
        c.append_from_stim_program_text("DEPOLARIZE1(0.01) 0 1\nM 0 1 2\nDETECTOR rec[-1]")
    _assert_same(port, ref)
    assert port[0] == port.cast_to_stim()[0]
    assert port == tsim_tpu_torch.Circuit(str(port))
    assert port.approx_equals(tsim_tpu_torch.Circuit(str(port)), atol=1e-9)


def _raised(call):
    with pytest.raises(Exception) as info:
        call()
    return type(info.value).__name__, str(info.value)


def test_stage_d_surface_raises():
    port, ref = models.distillation_d3(p=0.05), jax_distillation.distillation_d3(p=0.05)
    calls = [
        lambda c: c.detector_error_model(decompose_errors=True),
        lambda c: c.diagram("nope"),
        lambda c: c.compile_m2d_converter().convert(measurements=np.zeros((2, 1), bool)),
        lambda c: c.detector_error_model(typo=True),
    ]
    for call in calls:
        got = _raised(lambda: call(port))
        assert got[0] in ("ValueError", "TypeError")
        assert got == _raised(lambda: call(ref))
