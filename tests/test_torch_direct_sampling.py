"""Fully-direct sampling in the port against tsim_tpu, bit for bit.

A program without components (every Clifford circuit compiles to one) is
drawn on the host, as ``tsim_tpu/sampler.py`` draws it: by the C++
Pauli-frame engine where tsim_tpu takes it (a card, here
``TSIM_TPU_NATIVE_DIRECT=1``, which both packages read), else by the seeded
host ``ChannelSampler``. Both routes give tsim_tpu's bits at the same seed,
on detector and measurement samplers, with the reference folds,
postselection masks (which a fully-direct program ignores, as in tsim_tpu)
and every output layout; checkpoints continue the stream as tsim_tpu's
pickle does. Mirrors ``tests/unit/test_sampler.py``'s native-direct cases.
The route's own cases, which need no JAX, are in
``test_torch_direct_route.py``.
"""

import numpy as np
import pytest

import tsim_tpu
import tsim_tpu_torch
from dev.export_torch_program import export_sampler
from tsim_tpu.models.surface_code import rotated_surface_code_memory_z as ref_surface_code
from tsim_tpu_torch import sampler as port_sampler
from tsim_tpu_torch.models.surface_code import rotated_surface_code_memory_z

SURFACE = dict(after_clifford_depolarization=0.02, before_measure_flip_probability=0.02,
               after_reset_flip_probability=0.01)
CIRCUITS = {
    # The flips of the frame engine become absolute values: detector 0 is 1 without noise.
    "flipped_baseline": "R 0\nX 0\nX_ERROR(0.25) 0\nM 0\nDETECTOR rec[-1]\nOBSERVABLE_INCLUDE(0) rec[-1]",
    # Constant detectors (tests/unit/test_sampler.py::TestConstantDirectDetectors).
    "constant": "X 0\nX_ERROR(0.4) 1\nM 0 1\nDETECTOR rec[-2]\nDETECTOR rec[-1]\nOBSERVABLE_INCLUDE(0) rec[-1]",
    "two_observables": (
        "R 0 1 2\nX 2\nX_ERROR(0.2) 0 1\nDEPOLARIZE1(0.1) 2\nCNOT 0 1\nM 0 1 2\nDETECTOR rec[-3] rec[-2]\n"
        "DETECTOR rec[-1]\nOBSERVABLE_INCLUDE(0) rec[-2]\nOBSERVABLE_INCLUDE(1) rec[-1]"
    ),
}
LAYOUTS = [
    {},
    {"separate_observables": True},
    {"append_observables": True},
    {"prepend_observables": True},
    {"prepend_observables": True, "append_observables": True},
    {"bit_packed": True},
    {"bit_packed": True, "separate_observables": True},
    {"bit_packed": True, "append_observables": True},
    {"bit_packed": True, "prepend_observables": True},
    {"use_detector_reference_sample": True},
    {"use_observable_reference_sample": True, "append_observables": True},
    {"use_detector_reference_sample": True, "use_observable_reference_sample": True, "separate_observables": True},
]


@pytest.fixture(params=["host_channels", "native_frame"])
def route(request, monkeypatch):
    if request.param == "native_frame":
        monkeypatch.setenv("TSIM_TPU_NATIVE_DIRECT", "1")
    else:
        monkeypatch.delenv("TSIM_TPU_NATIVE_DIRECT", raising=False)
    return request.param


def _circuits(name):
    if name == "surface_d3":
        return rotated_surface_code_memory_z(3, 3, **SURFACE), ref_surface_code(3, 3, **SURFACE)
    return tsim_tpu_torch.Circuit(CIRCUITS[name]), tsim_tpu.Circuit(CIRCUITS[name])


def _assert_same(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
        return
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------- detector samplers
@pytest.mark.parametrize("name", ["surface_d3", *sorted(CIRCUITS)])
def test_detector_sampler_bits_equal_in_every_layout(route, name):
    port_circuit, ref_circuit = _circuits(name)
    port = port_circuit.compile_detector_sampler(seed=7, device="cpu")
    ref = ref_circuit.compile_detector_sampler(seed=7)
    assert port.direct_route == route and f"{route} route)" in repr(port)
    for kw in LAYOUTS:  # one stream: every call continues it on both sides
        _assert_same(port.sample(333, **kw), ref.sample(333, **kw))
    mask = np.ones(port_circuit.num_detectors, bool)
    _assert_same(port.sample(200, postselection_mask=mask, use_detector_reference_sample=True),
                 ref.sample(200, postselection_mask=mask, use_detector_reference_sample=True))


def test_surface_d5_detector_bits_equal(route):
    port = rotated_surface_code_memory_z(5, 5, **SURFACE).compile_detector_sampler(seed=3, device="cpu")
    ref = ref_surface_code(5, 5, **SURFACE).compile_detector_sampler(seed=3)
    det, obs = port.sample(2000, separate_observables=True)
    _assert_same((det, obs), ref.sample(2000, separate_observables=True))
    assert 0.005 < det.mean() < 0.2


def test_flipped_baseline_means(route):
    """The absolute detector values, not the frame engine's flips
    (tests/unit/test_sampler.py::test_native_direct_deterministic_one_detector)."""
    s = tsim_tpu_torch.Circuit(CIRCUITS["flipped_baseline"]).compile_detector_sampler(seed=2, device="cpu")
    det, obs = s.sample(4000, separate_observables=True)
    assert abs(det.mean() - 0.75) < 0.04 and abs(obs.mean() - 0.75) < 0.04
    packed = s.sample(4000, bit_packed=True)
    assert abs(np.unpackbits(packed, axis=1, bitorder="little")[:, 0].mean() - 0.75) < 0.04
    assert not s.sample(100, use_detector_reference_sample=True).all()


def test_routes_agree_in_distribution(monkeypatch):
    """tests/unit/test_sampler.py::test_native_direct_path_statistics."""
    c = rotated_surface_code_memory_z(3, 3, after_clifford_depolarization=0.02, before_measure_flip_probability=0.02)
    monkeypatch.setenv("TSIM_TPU_NATIVE_DIRECT", "1")
    det, _ = c.compile_detector_sampler(seed=11, device="cpu").sample(40000, separate_observables=True)
    monkeypatch.delenv("TSIM_TPU_NATIVE_DIRECT")
    host = c.compile_detector_sampler(seed=12, device="cpu")
    assert host.direct_route == "host_channels"
    det2, _ = host.sample(40000, separate_observables=True)
    a, b = det.mean(axis=0), det2.mean(axis=0)
    sig = np.sqrt(a * (1 - a) / 4e4 + b * (1 - b) / 4e4) + 1e-9
    assert (np.abs(a - b) / sig).max() < 5.5, (a, b)


# ---------------------------------------------------- measurement samplers
@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_measurement_sampler_bits_equal(route, name):
    port_circuit, ref_circuit = _circuits(name)
    port = port_circuit.compile_sampler(seed=4, device="cpu")
    ref = ref_circuit.compile_sampler(seed=4)
    assert not port._program.components and port.direct_route == route
    for shots in (500, 65):
        _assert_same(port.sample(shots), ref.sample(shots))


# -------------------------------------------------------- the route itself
def test_non_clifford_fully_direct_takes_host_channels(monkeypatch):
    """A fully-direct program of a non-Clifford circuit has no frame engine:
    the host route on either setting, with tsim_tpu's bits."""
    monkeypatch.setenv("TSIM_TPU_NATIVE_DIRECT", "1")
    text = "T 0\nX_ERROR(0.1) 1\nM 1\nDETECTOR rec[-1]"
    port = tsim_tpu_torch.Circuit(text).compile_detector_sampler(seed=5, device="cpu")
    ref = tsim_tpu.Circuit(text).compile_detector_sampler(seed=5)
    assert not port._program.components and ref._native_frame_sampler() is None
    assert port.direct_route == "host_channels" and port._native_frame_sampler() is None
    _assert_same(port.sample(1000), ref.sample(1000))


def test_exported_program_samples_from_its_noise_model(monkeypatch):
    """A program that comes as data has no circuit: the host route, on the
    noise model's channels, with the bits of tsim_tpu's sampler it came from."""
    ref = tsim_tpu.Circuit(CIRCUITS["two_observables"]).compile_detector_sampler(seed=9)
    port = port_sampler.CompiledDetectorSampler(export_sampler(ref), seed=9, device="cpu")
    monkeypatch.setenv("TSIM_TPU_NATIVE_DIRECT", "1")
    assert port.circuit is None and port.direct_route == "host_channels"
    monkeypatch.delenv("TSIM_TPU_NATIVE_DIRECT")  # tsim_tpu's host route
    _assert_same(port.sample(700, append_observables=True), ref.sample(700, append_observables=True))


# ------------------------------------------------------------- checkpoints
@pytest.mark.parametrize("cls", ["detector", "measurement"])
def test_checkpoint_round_trip_matches_tsim_tpu(route, cls, tmp_path):
    """Save after one call, load, sample: the host route continues its
    stream, the frame engine restarts from its seed, as tsim_tpu's pickle
    does (its ``__getstate__`` drops the engine)."""
    text = CIRCUITS["constant"]
    compile_ = "compile_detector_sampler" if cls == "detector" else "compile_sampler"
    port = getattr(tsim_tpu_torch.Circuit(text), compile_)(seed=13, device="cpu")
    ref = getattr(tsim_tpu.Circuit(text), compile_)(seed=13)
    _assert_same(port.sample(300), ref.sample(300))
    port.save(tmp_path / "port.ckpt")
    ref.save(tmp_path / "ref.pkl")
    port_loaded = type(port).load(tmp_path / "port.ckpt")
    ref_loaded = type(ref).load(tmp_path / "ref.pkl")
    assert port_loaded.direct_route == route and str(port_loaded.circuit) == str(port.circuit)
    _assert_same(port_loaded.sample(300), ref_loaded.sample(300))
    _assert_same(port.sample(300), ref.sample(300))
