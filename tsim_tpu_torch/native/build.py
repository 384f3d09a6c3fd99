"""Lazy build + load of the native C++ engine via ctypes.

No packaging dependencies (pybind11 is unavailable): the shared object is
compiled with g++ on first use and cached under
``build/tsim_tpu_torch/native/`` beside the package (next to the CUDA
library of ``kernels/build.py``), keyed by a hash of the source, the flags
and the target that ``-march=native`` resolves to on this host, so repeat
imports are instant, source edits rebuild, and a build directory copied to
another CPU is rebuilt there instead of loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_SRC_DIR = os.path.join(os.path.dirname(__file__), "src")
_BUILD_DIR = str(Path(__file__).resolve().parents[2] / "build" / "tsim_tpu_torch" / "native")
_LOCK = threading.Lock()
_CACHE: dict[str, ctypes.CDLL] = {}


class NativeBuildError(RuntimeError):
    pass


def _host_target() -> bytes:
    """g++'s target options under ``-march=native`` on this host: the CPU
    and every instruction-set switch the build would use."""
    try:
        return subprocess.run(
            ["g++", "-march=native", "-Q", "--help=target"],
            check=True, capture_output=True,
        ).stdout
    except FileNotFoundError as e:
        raise NativeBuildError(f"g++ not available: {e}") from e
    except subprocess.CalledProcessError as e:
        raise NativeBuildError(f"g++ cannot resolve -march=native:\n{e.stderr.decode(errors='replace')}") from e


_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]


def library_path(name: str) -> str:
    """Where ``src/<name>.cpp`` is built on this host: the file name hashes
    the source, the flags and :func:`_host_target`."""
    with open(os.path.join(_SRC_DIR, f"{name}.cpp"), "rb") as fh:
        digest = hashlib.sha256(
            fh.read() + " ".join(_FLAGS).encode() + _host_target()
        ).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"{name}-{digest}.so")


def load_library(name: str) -> ctypes.CDLL:
    """Compile (if needed) and dlopen ``src/<name>.cpp``; a failure of
    either raises :class:`NativeBuildError`."""
    with _LOCK:
        lib = _CACHE.get(name)
        if lib is not None:
            return lib
        src = os.path.join(_SRC_DIR, f"{name}.cpp")
        so_path = library_path(name)
        os.makedirs(_BUILD_DIR, exist_ok=True)
        if not os.path.exists(so_path):
            tmp = so_path + f".tmp{os.getpid()}"
            cmd = ["g++", *_FLAGS, src, "-o", tmp]
            try:
                subprocess.run(cmd, check=True, capture_output=True, text=True)
            except FileNotFoundError as e:
                raise NativeBuildError(f"g++ not available: {e}") from e
            except subprocess.CalledProcessError as e:
                raise NativeBuildError(
                    f"native build failed:\n{e.stderr}"
                ) from e
            os.replace(tmp, so_path)
        try:
            lib = ctypes.CDLL(so_path)
        except OSError as e:
            raise NativeBuildError(f"cannot load {so_path}: {e}") from e
        _CACHE[name] = lib
        return lib
