"""Wrappers of the CUDA exact-evaluation kernels (``csrc/exact_eval.cu``).

Each wrapper checks its inputs, allocates the output, launches on
PyTorch's current stream, raises if the launch fails and counts the
launch. There is no fallback: the plain version
(``compile/evaluate.py``) runs only for CPU tensors, chosen by the caller
(``compile/exact_eval.py``).

Kernels by name (and the TPU kernel each replaces):
``exact_wide`` (K5), ``approx_wide`` (K6), ``exact_small`` (K7a),
``approx_small`` (K7b); ``approx_ablate`` counts the launches of K6's stage
split (``dev/torch_kernel_ablate.py``).
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .sample_eval import layout as configuration

MAX_TILE = 128  # graphs per block of the wide configuration

KERNELS = ("exact_wide", "approx_wide", "exact_small", "approx_small")

# Variants of tsim_approx_eval_ablate, by position: the prefactor and the graph
# sum alone; with the integer stage, its parities consumed without factors;
# every stage (K6's own code).
APPROX_ABLATION_VARIANTS = ("empty", "par-all", "full")

# Launches per kernel, counted where each launch succeeds, and the same per
# device ({"cuda:0": {name: launches}}).
launch_counts = {name: 0 for name in (*KERNELS, "approx_ablate")}
device_launch_counts: dict[str, dict[str, int]] = {}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0
    device_launch_counts.clear()


def graph_tile(num_graphs: int) -> int:
    """Graphs per wide block: a power of two from 32 to MAX_TILE."""
    tile = 32
    while tile < min(num_graphs, MAX_TILE):
        tile *= 2
    return tile


def num_tiles(num_graphs: int) -> int:
    """Partials per row: graph tiles when wide, else one."""
    if configuration(num_graphs) == "small":
        return 1
    tile = graph_tile(num_graphs)
    return -(-num_graphs // tile)


def _check(tables, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the exact kernels take CUDA tensors, got {x.device}")
    if x.dtype != torch.uint8 or x.dim() != 2 or x.shape[1] != tables.n_params:
        raise ValueError(f"expected (B, {tables.n_params}) uint8, got {tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("parameter rows must be contiguous")
    for buf in (tables.flat, tables.approx):
        if buf.device != x.device or not buf.is_contiguous():
            raise ValueError(f"tables on {buf.device}, rows on {x.device}")
    if tables.flat.dtype != torch.int32 or tables.approx.dtype != torch.float32:
        raise ValueError("exact tables must be int32 with float32 approximate factors")
    if tables.num_graphs <= 0:
        raise ValueError("the exact kernels need at least one graph")


def _launch(name: str, err: int, lib, tables) -> None:
    if err != 0:
        msg = lib.tsim_cuda_error_string(err).decode()
        raise RuntimeError(
            f"{name} launch failed on {tables.num_graphs} graphs over {tables.n_params} "
            f"parameters: cudaError {err}: {msg}"
        )
    launch_counts[name] += 1
    device_launch_counts.setdefault(str(tables.flat.device), dict.fromkeys(launch_counts, 0))[name] += 1


def exact_partials(tables, x: torch.Tensor):
    """(B, P) uint8 rows on a CUDA device -> exact per-tile graph sums:
    coefficients (n_tiles, B, 4) int32 and power (n_tiles, B) int32, for a
    rung without approximate floatfactors (K5 wide, K7a small)."""
    _check(tables, x)
    if tables.approximate:
        raise ValueError("this rung has approximate floatfactors; use approx_partials")
    G, B = tables.num_graphs, x.shape[0]
    n = num_tiles(G)
    out_c = torch.empty((n, B, 4), dtype=torch.int32, device=x.device)
    out_p = torch.empty((n, B), dtype=torch.int32, device=x.device)
    if B == 0:
        return out_c, out_p
    lib = build.load()
    config = configuration(G)
    t1, t2, t3, t4 = tables.dims
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tsim_exact_eval(
            ctypes.c_void_p(x.data_ptr()), B, tables.n_params,
            ctypes.c_void_p(tables.flat.data_ptr()), G, t1, t2, t3, t4, tables.words,
            int(config == "wide"), graph_tile(G),
            ctypes.c_void_p(out_c.data_ptr()), ctypes.c_void_p(out_p.data_ptr()),
            ctypes.c_void_p(stream),
        )
    _launch(f"exact_{config}", err, lib, tables)
    return out_c, out_p


def _approx_call(tables, x: torch.Tensor, variant: int | None) -> torch.Tensor:
    """One launch of the approximate finisher in the rung's configuration, or,
    with ``variant``, of that variant of the wide kernel's stage split."""
    _check(tables, x)
    if not tables.approximate:
        raise ValueError("this rung has no approximate floatfactors; use exact_partials")
    G, B = tables.num_graphs, x.shape[0]
    config = configuration(G)
    if variant is not None and config != "wide":
        raise ValueError(f"the stage split is of the wide kernel; {G} graphs take the small one")
    out = torch.empty((num_tiles(G), B, 2), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    lib = build.load()
    shape = (*tables.dims, tables.words, *tables.closed_form)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        head = (ctypes.c_void_p(x.data_ptr()), B, tables.n_params,
                ctypes.c_void_p(tables.flat.data_ptr()), G, *shape)
        tail = (ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(stream))
        if variant is None:
            err = lib.tsim_approx_eval(*head, int(config == "wide"), graph_tile(G), *tail)
        else:
            err = lib.tsim_approx_eval_ablate(*head, graph_tile(G), variant, *tail)
    _launch("approx_ablate" if variant is not None else f"approx_{config}", err, lib, tables)
    return out


def approx_partials(tables, x: torch.Tensor) -> torch.Tensor:
    """(B, P) uint8 rows on a CUDA device -> (n_tiles, B, 2) float32 (re, im)
    per-tile graph sums, for a rung with approximate floatfactors (K6 wide,
    K7b small)."""
    return _approx_call(tables, x, None)


def ablate_approx(tables, x: torch.Tensor, variant: str) -> torch.Tensor:
    """K6 with the stages of ``variant`` (one of APPROX_ABLATION_VARIANTS):
    per-tile partials as :func:`approx_partials` gives them."""
    if variant not in APPROX_ABLATION_VARIANTS:
        raise ValueError(f"variant must be one of {APPROX_ABLATION_VARIANTS}, got {variant!r}")
    return _approx_call(tables, x, APPROX_ABLATION_VARIANTS.index(variant))
