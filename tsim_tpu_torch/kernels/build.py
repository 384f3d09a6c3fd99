"""Builds the port's CUDA sources into a shared library and loads it with ctypes.

``nvcc`` compiles each of ``kernels/csrc/*.cu`` (plain C interface, no
PyTorch headers; they share the headers ``csrc/*.cuh``) for ``sm_90a``, all
sources at once in parallel processes, and links them into
``build/tsim_tpu_torch/<hash>/`` beside the package, at first use; the
directory name is a hash of the sources, headers and flags, so an edited
file builds anew. Nothing is imported or compiled
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v", "-Xcompiler", "-fPIC")
LIB_NAME = "libtsim_kernels.so"

_lib: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


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
    for src in (*sources(), *headers()):
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
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources()]
        cmds = [
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            for src, obj in zip(sources(), objs)
        ]
        procs = [
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for cmd in cmds
        ]
        logs = [proc.communicate()[0] for proc in procs]
        (lib.parent / "ptxas.log").write_text("".join(logs))
        for cmd, proc, log in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
        out = Path(tmp) / LIB_NAME
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(out), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(out, lib)
    return lib


def load() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare every signature."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.tsim_sample_eval.argtypes = [
            vp, i64, i32, vp, i32, i32, i32, i32, i32, i32, i32, i32, vp, vp,
        ]
        lib.tsim_sample_eval.restype = i32
        lib.tsim_sample_eval_ablate.argtypes = [
            vp, i64, i32, vp, i32, i32, i32, i32, i32, i32, i32, vp, vp,
        ]
        lib.tsim_sample_eval_ablate.restype = i32
        lib.tsim_exact_eval.argtypes = [
            vp, i64, i32, vp, i32, i32, i32, i32, i32, i32, i32, i32, vp, vp, vp,
        ]
        lib.tsim_exact_eval.restype = i32
        lib.tsim_approx_eval.argtypes = [
            vp, i64, i32, vp, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, vp, vp,
        ]
        lib.tsim_approx_eval.restype = i32
        lib.tsim_approx_eval_ablate.argtypes = lib.tsim_approx_eval.argtypes
        lib.tsim_approx_eval_ablate.restype = i32
        lib.tsim_noise_draw.argtypes = [vp, i64, i32, vp, i32, i32, i32, vp, vp]
        lib.tsim_noise_draw.restype = i32
        lib.tsim_cuda_error_string.argtypes = [i32]
        lib.tsim_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
