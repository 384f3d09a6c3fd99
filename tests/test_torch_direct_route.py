"""The route of a fully-direct program in the port, with no JAX.

A program without components is drawn on the host: by the C++ Pauli-frame
engine on a CUDA sampler (or with ``TSIM_TPU_NATIVE_DIRECT=1``), else by the
host ``ChannelSampler``; ``direct_route`` names which. An engine that cannot
be built or loaded raises ``NativeBuildError``: the sampler never switches
route on an error. This file imports neither JAX nor tsim_tpu, so it also
runs on the card's machine (``--noconftest``), where the ``cuda`` case takes
the card; ``test_torch_direct_sampling.py`` holds the bits to tsim_tpu's.
"""

import numpy as np
import pytest
import torch

import tsim_tpu_torch
from tsim_tpu_torch.models.surface_code import rotated_surface_code_memory_z
from tsim_tpu_torch.native import build

SURFACE = dict(after_clifford_depolarization=0.02, before_measure_flip_probability=0.02,
               after_reset_flip_probability=0.01)
CONSTANT = "X 0\nX_ERROR(0.4) 1\nM 0 1\nDETECTOR rec[-2]\nDETECTOR rec[-1]\nOBSERVABLE_INCLUDE(0) rec[-1]"


def test_programs_with_components_have_no_direct_route():
    s = tsim_tpu_torch.Circuit("H 0\nT 0\nH 0\nM 0\nDETECTOR rec[-1]").compile_detector_sampler(seed=0, device="cpu")
    assert s._program.components and s.direct_route is None and "route" not in repr(s)


def test_native_build_failure_raises(monkeypatch):
    """No silent fallback: a frame engine that cannot be built raises."""
    monkeypatch.setenv("TSIM_TPU_NATIVE_DIRECT", "1")

    def fail(name):
        raise build.NativeBuildError(f"native build failed: {name}")

    monkeypatch.setattr(build, "load_library", fail)
    s = rotated_surface_code_memory_z(3, 2, **SURFACE).compile_detector_sampler(seed=0, device="cpu")
    assert s.direct_route == "native_frame"
    with pytest.raises(build.NativeBuildError, match="frame_kernels"):
        s.sample(10)
    with pytest.raises(build.NativeBuildError):
        s.sample(10, use_detector_reference_sample=True)
    m = tsim_tpu_torch.Circuit(CONSTANT).compile_sampler(seed=0, device="cpu")
    with pytest.raises(build.NativeBuildError):
        m.sample(10)


def test_native_load_failure_raises(monkeypatch, tmp_path):
    """A library that cannot be loaded raises NativeBuildError too."""
    monkeypatch.setenv("TSIM_TPU_NATIVE_DIRECT", "1")
    broken = tmp_path / "frame_kernels-broken.so"
    broken.write_bytes(b"not a shared object")
    monkeypatch.setattr(build, "_CACHE", {})
    monkeypatch.setattr(build, "library_path", lambda name: str(broken))
    s = tsim_tpu_torch.Circuit(CONSTANT).compile_detector_sampler(seed=0, device="cpu")
    with pytest.raises(build.NativeBuildError, match="cannot load"):
        s.sample(10, separate_observables=True)


def test_route_follows_the_device_and_the_variable(monkeypatch):
    """The route is chosen by the program, the circuit and the device (and
    the variable), read at each call as tsim_tpu reads it."""
    monkeypatch.delenv("TSIM_TPU_NATIVE_DIRECT", raising=False)
    s = tsim_tpu_torch.Circuit(CONSTANT).compile_detector_sampler(seed=3, device="cpu")
    assert s.direct_route == "host_channels" and s.sample(5).shape == (5, 2)
    monkeypatch.setenv("TSIM_TPU_NATIVE_DIRECT", "1")
    assert s.direct_route == "native_frame" and s.sample(5).shape == (5, 2)
    t = tsim_tpu_torch.Circuit("T 0\nX_ERROR(0.1) 1\nM 1\nDETECTOR rec[-1]").compile_detector_sampler(
        seed=3, device="cpu"
    )
    assert not t._program.components and t.direct_route == "host_channels"


# --------------------------------------------------------------- the card
@pytest.mark.cuda
def test_cuda_sampler_takes_the_frame_engine(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.delenv("TSIM_TPU_NATIVE_DIRECT", raising=False)
    c = rotated_surface_code_memory_z(3, 3, **SURFACE)
    s = c.compile_detector_sampler(seed=7)
    assert s.device.type == "cuda" and s.direct_route == "native_frame"
    monkeypatch.setenv("TSIM_TPU_NATIVE_DIRECT", "1")
    cpu = c.compile_detector_sampler(seed=7, device="cpu")
    assert cpu.direct_route == "native_frame"
    for got, want in zip(s.sample(1000, separate_observables=True), cpu.sample(1000, separate_observables=True)):
        np.testing.assert_array_equal(got, want)
