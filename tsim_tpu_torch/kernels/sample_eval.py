"""Wrapper of the CUDA sampling kernel (``csrc/sample_eval.cu``).

It checks its inputs, allocates the output, launches on PyTorch's current
stream and raises if the launch fails. There is no fallback: the plain
version (``compile/sample_eval.py::sample_product_sum_reference``) runs
only for CPU tensors, chosen by the caller.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

SMALL_G_CUTOFF = 24  # graphs; fewer take the one-thread-per-shot configuration

# Launches per configuration, counted where each launch succeeds.
launch_counts = {"wide": 0, "small": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def configuration(num_graphs: int) -> str:
    return "small" if num_graphs < SMALL_G_CUTOFF else "wide"


def sample_product_sum(tables, x: torch.Tensor) -> torch.Tensor:
    """(B, P) uint8 parameter rows on a CUDA device -> (B, 2) float32 (re, im)
    of the graph-summed product, for the rung held by ``tables``."""
    if x.device.type != "cuda":
        raise ValueError(f"the sampling kernel takes CUDA tensors, got {x.device}")
    if x.dtype != torch.uint8 or x.dim() != 2 or x.shape[1] != tables.n_params:
        raise ValueError(
            f"expected (B, {tables.n_params}) uint8, got {tuple(x.shape)} {x.dtype}"
        )
    if not x.is_contiguous():
        raise ValueError("parameter rows must be contiguous")
    flat = tables.flat
    if flat.device != x.device or flat.dtype != torch.int32 or not flat.is_contiguous():
        raise ValueError(f"tables on {flat.device} ({flat.dtype}), rows on {x.device}")
    if tables.num_graphs <= 0:
        raise ValueError("the sampling kernel needs at least one graph")
    B = x.shape[0]
    out = torch.empty((B, 2), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    lib = build.load()
    config = configuration(tables.num_graphs)
    t1, t2, t3, t4 = tables.dims
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tsim_sample_eval(
            ctypes.c_void_p(x.data_ptr()), B, tables.n_params,
            ctypes.c_void_p(flat.data_ptr()), tables.num_graphs,
            t1, t2, t3, t4, tables.words, int(config == "wide"),
            ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(stream),
        )
    if err != 0:
        msg = lib.tsim_cuda_error_string(err).decode()
        raise RuntimeError(f"sample_eval ({config}) launch failed: cudaError {err}: {msg}")
    launch_counts[config] += 1
    return out
