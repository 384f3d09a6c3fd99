"""Builds the port's CUDA sources into a shared library and loads it with ctypes.

``nvcc`` compiles ``kernels/csrc/*.cu`` (plain C interface, no PyTorch
headers) for ``sm_90a`` into ``build/tsim_tpu_torch/<hash>/`` beside the
package, at first use; the directory name is a hash of the sources and
flags, so an edited source builds anew. Nothing is imported or compiled
when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "tsim_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)
LIB_NAME = "libtsim_kernels.so"

_lib: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; cannot build the CUDA kernels")
    return str(path)


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    return BUILD_ROOT / _digest() / LIB_NAME


def build() -> Path:
    """Compile the library if it is not built yet; return its path.

    The compiler's report (``-Xptxas -v``: registers, shared memory and
    spills per kernel) is kept beside the library as ``ptxas.log``.
    """
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (lib.parent / "ptxas.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare every signature."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.tsim_sample_eval.argtypes = [
            vp, i64, i32, vp, i32, i32, i32, i32, i32, i32, i32, vp, vp,
        ]
        lib.tsim_sample_eval.restype = i32
        lib.tsim_cuda_error_string.argtypes = [i32]
        lib.tsim_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
