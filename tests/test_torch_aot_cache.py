"""AOT compile-cache tests of the port (``tsim_tpu_torch/compile/aot_cache.py``),
mirrored from ``tests/unit/test_aot_cache.py``; the samplers run on the CPU.

The cache memoizes (prepare_graph + compile_program) output keyed on the
circuit text + compile flags + a source-tree fingerprint, so a second
``compile_detector_sampler()`` of an identical circuit skips compilation
entirely (exceeds the reference, which recompiles every time — SURVEY.md
section 5.4).
"""

import shutil
import time

import numpy as np
import pytest

from tsim_tpu_torch import program_io
from tsim_tpu_torch.circuit import Circuit
from tsim_tpu_torch.compile import aot_cache
from tsim_tpu_torch.native import build as native_build
from tsim_tpu_torch.sampler import compile_circuit
from tsim_tpu_torch.zx import native_simplify

# The original's circuit with an H after the T, so that its detector is a
# component and not a direct output: the port samples no program without
# components yet (ROADMAP.md item 1.8).
CIRC = """
H 0
CNOT 0 1
T 1
H 1
X_ERROR(0.2) 0
M 0 1
DETECTOR rec[-1] rec[-2]
"""


@pytest.fixture(autouse=True)
def _fresh_cache():
    aot_cache.clear_memory()
    yield
    aot_cache.clear_memory()


def test_second_compile_skips_pipeline(monkeypatch):
    c = Circuit(CIRC)
    s1 = c.compile_detector_sampler(seed=0, device="cpu")

    import tsim_tpu_torch.sampler as sampler_mod

    def _boom(*a, **k):  # pragma: no cover - failure path
        raise AssertionError("prepare_graph ran despite a warm cache")

    monkeypatch.setattr(sampler_mod, "prepare_graph", _boom)
    t0 = time.perf_counter()
    s2 = Circuit(CIRC).compile_detector_sampler(seed=0, device="cpu")
    assert time.perf_counter() - t0 < 1.0
    assert s2._program is s1._program  # shared immutable program


def test_cached_sampler_stream_matches(monkeypatch):
    """Seeded sample streams are identical with and without a cache hit."""
    a = Circuit(CIRC).compile_detector_sampler(seed=7, device="cpu").sample(300, batch_size=100)
    b = Circuit(CIRC).compile_detector_sampler(seed=7, device="cpu").sample(300, batch_size=100)
    np.testing.assert_array_equal(a, b)


def test_key_separates_modes_and_flags():
    k = aot_cache.cache_key
    base = k("H 0", sample_detectors=True, mode="sequential", strategy="cat5")
    assert k("H 0", sample_detectors=False, mode="sequential", strategy="cat5") != base
    assert k("H 0", sample_detectors=True, mode="joint", strategy="cat5") != base
    assert k("H 0", sample_detectors=True, mode="sequential", strategy="bss") != base
    assert k("H 1", sample_detectors=True, mode="sequential", strategy="cat5") != base
    assert k("H 0", sample_detectors=True, mode="sequential", strategy="cat5") == base


def test_disable_via_env(monkeypatch):
    monkeypatch.setenv("TSIM_TPU_COMPILE_CACHE", "0")
    c = Circuit(CIRC)
    c.compile_detector_sampler(seed=0, device="cpu")
    assert aot_cache.fetch(
        aot_cache.cache_key(
            str(c._stim_circ), sample_detectors=True, mode="sequential",
            strategy="cat5",
        )
    ) is None


def test_disk_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setenv("TSIM_TPU_COMPILE_CACHE_DIR", str(tmp_path))
    c = Circuit(CIRC)
    s1 = c.compile_detector_sampler(seed=3, device="cpu")
    files = list(tmp_path.glob("aot_*.npz"))
    assert len(files) == 1
    # A fresh process would miss the memory cache; simulate by clearing it.
    aot_cache.clear_memory()
    s2 = Circuit(CIRC).compile_detector_sampler(seed=3, device="cpu")
    assert s2._program is not s1._program
    a = s1.sample(200, batch_size=100)
    b = s2.sample(200, batch_size=100)
    np.testing.assert_array_equal(a, b)


def _exported(sampler):
    return program_io.ExportedProgram(
        program=sampler._program, noise=sampler._noise, num_detectors=sampler._num_detectors
    )


def test_disk_entry_is_the_compiled_program_leaf_for_leaf(tmp_path, monkeypatch):
    """An entry read back from disk has every leaf's dtype, shape and value,
    and the same header, as the program compiled in this process."""
    monkeypatch.setenv("TSIM_TPU_COMPILE_CACHE_DIR", str(tmp_path))
    fresh = _exported(Circuit(CIRC).compile_detector_sampler(seed=3, device="cpu"))
    aot_cache.clear_memory()
    read = _exported(Circuit(CIRC).compile_detector_sampler(seed=3, device="cpu"))
    assert read.program is not fresh.program
    assert program_io.leaf_differences(fresh, read) == []


def test_corrupt_disk_entry_is_a_miss(tmp_path, monkeypatch):
    monkeypatch.setenv("TSIM_TPU_COMPILE_CACHE_DIR", str(tmp_path))
    Circuit(CIRC).compile_detector_sampler(seed=0, device="cpu")
    [path] = tmp_path.glob("aot_*.npz")
    path.write_bytes(b"not a zip")
    aot_cache.clear_memory()
    key = aot_cache.cache_key(str(Circuit(CIRC)._stim_circ), sample_detectors=True, mode="sequential", strategy="cat5")
    assert aot_cache.fetch(key) is None
    Circuit(CIRC).compile_detector_sampler(seed=0, device="cpu")  # compiles anew


def _key(c):
    return aot_cache.cache_key(str(c._stim_circ), sample_detectors=True, mode="sequential", strategy="cat5")


@pytest.mark.skipif(native_simplify._load() is None, reason="needs the native ZX engine (g++)")
def test_a_native_fallback_reports_mixed_and_is_not_cached(monkeypatch):
    """One native call that hands its graph back to the Python engine makes
    the compile "mixed" in ``compile_stats``, and such a compile is not
    stored under the native engine's key; a clean compile is "native"."""
    encode, calls = native_simplify.encode_graph, []

    def fail_first(g, enc):
        calls.append(None)
        if len(calls) == 1:
            raise OverflowError("forced: the native engine declines this graph")
        return encode(g, enc)

    monkeypatch.setattr(native_simplify, "encode_graph", fail_first)
    before = native_simplify.fallbacks
    c = Circuit(CIRC)
    _, stats = compile_circuit(c, sample_detectors=True, mode="sequential")
    assert native_simplify.fallbacks == before + 1
    assert stats["planner"] == "mixed"
    assert aot_cache.fetch(_key(c)) is None
    monkeypatch.setattr(native_simplify, "encode_graph", encode)
    _, stats = compile_circuit(c, sample_detectors=True, mode="sequential")
    assert native_simplify.fallbacks == before + 1
    assert stats["planner"] == "native"
    assert aot_cache.fetch(_key(c)) is not None


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")
def test_native_library_path_names_the_host_target(monkeypatch):
    """The engine's file name changes with the target ``-march=native``
    resolves to, so a build directory copied from another CPU is rebuilt
    and not loaded."""
    here = native_build.library_path("zx_reduce")
    assert native_build.library_path("zx_reduce") == here
    monkeypatch.setattr(native_build, "_host_target", lambda: b"-march= another-cpu")
    assert native_build.library_path("zx_reduce") != here
