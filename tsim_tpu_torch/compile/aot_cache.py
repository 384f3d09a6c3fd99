"""Ahead-of-time compile cache.

Compilation (``prepare_graph`` + ``compile_program``) is a deterministic
pure function of the circuit text and the compile flags, so its output —
a ``program_io.CompiledProgram`` of plain numpy arrays plus the channel
data the sampler needs — can be memoized across sampler constructions and,
optionally, across processes on disk. The reference keeps compilation
artifacts only in memory (SURVEY.md section 5.4: "consider serializing
CompiledProgram pytrees"); with this cache a repeat
``compile_detector_sampler()`` of an identical circuit returns in
milliseconds instead of the seconds a compile takes.

Keying: sha256 over (code fingerprint, circuit text, sample_detectors,
mode, strategy). The code fingerprint hashes every compile-relevant
source file of this package so editing the planner or a rewrite rule
invalidates stale entries automatically. The sampler seed is deliberately
NOT part of the key: compilation is seed-independent (the planner uses its
own fixed RNG), and all RNG state is rebuilt per sampler.

The in-process memory cache is always on (entries are immutable
dataclasses, safe to share between samplers). The on-disk cache is opt-in
via ``TSIM_TPU_COMPILE_CACHE_DIR=<path>`` (one ``.npz`` a key under that
directory, written and read by ``program_io.write_npz``/``read_npz``, no
pickle); set ``TSIM_TPU_COMPILE_CACHE=0`` to disable caching entirely.
"""

from __future__ import annotations

import hashlib
import os
from typing import NamedTuple

import numpy as np

from ..program_io import ExportedProgram, NoiseModel, flatten, read_npz, unflatten, write_npz

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Source trees whose contents determine compilation output.
_FINGERPRINT_DIRS = ("zx", "compile", "core", "noise", "stim_core", "native/src")

_code_fp_cache: str | None = None
_memory: dict[str, "CompiledEntry"] = {}
# In-process entries pin whole compiled programs; bound the cache so
# sweep-style processes (13+ heavy compiles) don't grow memory forever.
_MEMORY_CAP = 24


def _remember(key: str, entry: "CompiledEntry") -> None:
    _memory[key] = entry
    while len(_memory) > _MEMORY_CAP:
        _memory.pop(next(iter(_memory)))


class CompiledEntry(NamedTuple):
    """Everything the sampler constructor needs downstream of compile."""

    program: object  # program_io.CompiledProgram
    channel_probs: object
    error_transform: object
    num_detectors: int


def _entry_arrays(entry: CompiledEntry) -> tuple[dict, dict]:
    """(arrays, header) of ``entry`` for ``write_npz``: the program as
    ``program_io.flatten`` writes it, then the channels' outcome
    probabilities and the error transform."""
    empty = NoiseModel(channels=(), signature_matrix=np.zeros((0, 0), np.uint8))
    arrays, header = flatten(
        ExportedProgram(program=entry.program, noise=empty, num_detectors=entry.num_detectors)
    )
    for i, probs in enumerate(entry.channel_probs):
        arrays[f"entry.channel_probs.{i}"] = np.asarray(probs)
    arrays["entry.error_transform"] = np.asarray(entry.error_transform)
    header["entry"] = {"num_channels": len(entry.channel_probs)}
    return arrays, header


def _entry_of(arrays: dict, header: dict) -> CompiledEntry:
    """The inverse of :func:`_entry_arrays`."""
    n = header.pop("entry")["num_channels"]
    channel_probs = [arrays.pop(f"entry.channel_probs.{i}") for i in range(n)]
    error_transform = arrays.pop("entry.error_transform")
    exported = unflatten(arrays, header)
    return CompiledEntry(
        program=exported.program,
        channel_probs=channel_probs,
        error_transform=error_transform,
        num_detectors=exported.num_detectors,
    )


def _code_fingerprint() -> str:
    global _code_fp_cache
    if _code_fp_cache is None:
        h = hashlib.sha256()
        for sub in _FINGERPRINT_DIRS:
            root = os.path.join(_PKG_ROOT, sub)
            if not os.path.isdir(root):
                continue
            for dirpath, _dirnames, filenames in sorted(os.walk(root)):
                for name in sorted(filenames):
                    if not name.endswith((".py", ".cpp", ".h")):
                        continue
                    path = os.path.join(dirpath, name)
                    h.update(os.path.relpath(path, _PKG_ROOT).encode())
                    with open(path, "rb") as fh:
                        h.update(fh.read())
        _code_fp_cache = h.hexdigest()
    return _code_fp_cache


def _enabled() -> bool:
    return os.environ.get("TSIM_TPU_COMPILE_CACHE", "1").strip() not in ("0", "off")


def _disk_dir() -> str | None:
    path = os.environ.get("TSIM_TPU_COMPILE_CACHE_DIR", "").strip()
    return path or None


def _env_salt() -> str:
    """Compile-affecting runtime configuration that the source hash misses.

    The projector-split order salts on the value decompose actually froze
    at import (not the live env var, which can drift after import)."""
    from ..zx import decompose as dz
    from ..zx import native_simplify as ns

    planner = "native" if ns._load() is not None else "python"
    return f"{planner}|{dz._PROJ_ORDER}"


def cache_key(
    circuit_text: str, *, sample_detectors: bool, mode: str, strategy: str
) -> str:
    h = hashlib.sha256()
    h.update(_code_fingerprint().encode())
    h.update(f"|{_env_salt()}|{sample_detectors}|{mode}|{strategy}|".encode())
    h.update(circuit_text.encode())
    return h.hexdigest()


def fetch(key: str) -> CompiledEntry | None:
    if not _enabled():
        return None
    entry = _memory.get(key)
    if entry is not None:
        return entry
    dirpath = _disk_dir()
    if dirpath is None:
        return None
    path = os.path.join(dirpath, f"aot_{key[:24]}.npz")
    try:
        entry = _entry_of(*read_npz(path))
    except Exception:
        # Best-effort contract: a corrupt/incompatible entry (a bad zip, a
        # missing key, another format version) is a cache miss, never an error.
        return None
    _remember(key, entry)
    return entry


def store(key: str, entry: CompiledEntry) -> None:
    if not _enabled():
        return
    _remember(key, entry)
    dirpath = _disk_dir()
    if dirpath is None:
        return
    try:
        os.makedirs(dirpath, exist_ok=True)
        path = os.path.join(dirpath, f"aot_{key[:24]}.npz")
        tmp = path + f".tmp.{os.getpid()}"
        write_npz(tmp, *_entry_arrays(entry))
        os.replace(tmp, path)
    except OSError:
        pass  # disk cache is best-effort


def clear_memory() -> None:
    """Drop the in-process cache (tests)."""
    _memory.clear()
