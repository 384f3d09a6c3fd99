"""Wrappers of the CUDA sampling kernels (``csrc/sample_eval.cu``).

Each launch checks its inputs, allocates the output, launches on PyTorch's
current stream, raises if the launch fails and counts the launch. There is
no fallback: the plain version
(``compile/sample_eval.py::sample_product_sum_reference``) runs only for CPU
tensors, chosen by the caller, which also runs the start-up self-test
(``compile/sample_eval.py::ensure_self_test``).

Configurations by name (and the TPU kernel each replaces): ``wide`` (K1) and
``small`` (K2), both with bit-sliced parities and any number of parameters,
``per_term_wide`` (K3a), ``per_term_small`` (K3b). ``wide`` has two
instances, 128 and 32 shots a block, chosen by row count
(:func:`wide_block_shots`) and equal bit for bit; launches of the 32-shot
one count as ``wide_32``. ``per_term_wide`` has the same two on rows of up
to 128 parameters (:func:`per_term_wide_groups`), the 32-shot one counted
as ``per_term_wide_32``. ``self_test`` counts the launches of the start-up
self-test (K4) and ``ablate`` those of the stage ablation (K8,
``dev/torch_kernel_ablate.py``).
"""

from __future__ import annotations

import ctypes
import os

import torch

from . import build

SMALL_G_CUTOFF = 24  # graphs; fewer take the one-thread-per-shot configurations

# Codes of tsim_sample_eval's ``config`` argument, by position.
CONFIGURATIONS = ("small", "wide", "per_term_small", "per_term_wide")

# Shots a block of the two instances of "wide", and the row count from which
# a launch takes the 128-shot one. Below it the 32-shot instance gives the
# card four times the blocks; from it on the 128-shot one walks the lists
# once per 128 shots instead of once per 32. Measured on an H100 (PERF.md
# section 6, PR 6: chip_smoke.py phase 8 times both at 128 to 65,536 rows).
WIDE_BLOCK_SHOTS = (32, 128)
WIDE_SMALL_ROWS = 16384

# Variants of tsim_sample_eval_ablate, by position, named as in
# dev/kernel_ablate.py: (name, families whose parities are formed, families
# whose factors are applied).
ABLATION_VARIANTS = (
    ("empty", (), ()),
    ("par1", (1,), ()),
    ("par-all", (1, 2, 3, 4), ()),
    ("par1+T1", (1,), (1,)),
    ("par+T1..T3", (1, 2, 3), (1, 2, 3)),
    ("full", (1, 2, 3, 4), (1, 2, 3, 4)),
)

# Launches per kernel, counted where each launch succeeds, and the same per
# device ({"cuda:0": {name: launches}}; a sharded sampler's kernels run on
# every device of its mesh).
launch_counts = {
    name: 0 for name in (*CONFIGURATIONS, "wide_32", "per_term_wide_32", "self_test", "ablate")
}
device_launch_counts: dict[str, dict[str, int]] = {}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0
    device_launch_counts.clear()


def layout(num_graphs: int) -> str:
    """"small" below SMALL_G_CUTOFF graphs, else "wide" (the TPU's
    transposed/wide split, ``pallas_sample._small_g_cutoff``)."""
    return "small" if num_graphs < SMALL_G_CUTOFF else "wide"


def use_packed() -> bool:
    """False where ``TSIM_TPU_SAMPLE_TPACK=0``, tsim_tpu's switch to the
    per-term kernels (``pallas_sample._use_tpack``), read at every call.
    The switch exists only to mirror tsim_tpu in tests: the per-term
    kernels are slower."""
    return os.environ.get("TSIM_TPU_SAMPLE_TPACK", "1") != "0"


def configuration(num_graphs: int, per_term: bool | None = None) -> str:
    """The f32 configuration of a rung: per-term only where ``per_term`` is
    true or, with ``per_term`` None, where the switch of :func:`use_packed`
    is off. Rows of any length take "wide" or "small": their planes are
    indexed by parameter. tsim_tpu's dispatch differs by the
    design of its kernels: it also falls back to its per-term kernels when the
    start-up probe of the packed ones fails, where the self-test here raises."""
    base = layout(num_graphs)
    if per_term is None:
        per_term = not use_packed()
    return f"per_term_{base}" if per_term else base


def wide_block_shots(rows: int) -> int:
    """Shots a block of "wide" for a launch of ``rows`` rows: 32 below
    WIDE_SMALL_ROWS, else 128. A launch takes at least one row."""
    if rows <= 0:
        raise ValueError(f"a launch takes at least one row, got {rows}")
    return 32 if rows < WIDE_SMALL_ROWS else 128


# Packed 32-bit words of a row up to which the per-term kernels hold it in
# registers (two 64-bit words, 128 parameters); longer rows go through
# shared memory in one 256-shot instance.
PER_TERM_REGISTER_WORDS = 4


def per_term_wide_groups(rows: int, words: int) -> int:
    """32-shot groups a block of "per_term_wide" for a launch of ``rows``
    rows of ``words`` packed words: 1 below WIDE_SMALL_ROWS, as "wide", on
    rows held in registers, else 4 (longer rows take their own 256-shot
    instance, which ignores it)."""
    return 1 if words <= PER_TERM_REGISTER_WORDS and 0 < rows < WIDE_SMALL_ROWS else 4


def _check(tables, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the sampling kernels take CUDA tensors, got {x.device}")
    if x.dtype != torch.uint8 or x.dim() != 2 or x.shape[1] != tables.n_params:
        raise ValueError(f"expected (B, {tables.n_params}) uint8, got {tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("parameter rows must be contiguous")
    flat = tables.flat
    if flat.device != x.device or flat.dtype != torch.int32 or not flat.is_contiguous():
        raise ValueError(f"tables on {flat.device} ({flat.dtype}), rows on {x.device}")
    if tables.num_graphs <= 0:
        raise ValueError("the sampling kernels need at least one graph")


def _call(entry: str, code: int, tables, x: torch.Tensor, count_as: str, *extra: int) -> torch.Tensor:
    """Launch ``entry`` (``tsim_sample_eval`` or ``tsim_sample_eval_ablate``)
    with its mode ``code`` and the ``extra`` int arguments that follow it,
    raise on failure, count under ``count_as``."""
    _check(tables, x)
    B = x.shape[0]
    out = torch.empty((B, 2), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    lib = build.load()
    t1, t2, t3, t4 = tables.dims
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(
            ctypes.c_void_p(x.data_ptr()), B, tables.n_params,
            ctypes.c_void_p(tables.flat.data_ptr()), tables.num_graphs,
            t1, t2, t3, t4, tables.words, code, *extra,
            ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(stream),
        )
    if err != 0:
        msg = lib.tsim_cuda_error_string(err).decode()
        raise RuntimeError(
            f"{entry} ({count_as}) launch failed on {tables.num_graphs} graphs over "
            f"{tables.n_params} parameters: cudaError {err}: {msg}"
        )
    launch_counts[count_as] += 1
    device_launch_counts.setdefault(str(x.device), dict.fromkeys(launch_counts, 0))[count_as] += 1
    return out


def launch(
    tables, x: torch.Tensor, config: str, count_as: str | None = None, *, _block_shots: int | None = None
) -> torch.Tensor:
    """One launch of configuration ``config`` (one of CONFIGURATIONS) on
    (B, P) uint8 rows on a CUDA device -> (B, 2) float32 (re, im). "wide"
    takes the instance :func:`wide_block_shots` chooses for B rows;
    ``_block_shots`` (32 or 128) forces one, for the tests and the timings
    that hold the two against each other."""
    if config not in CONFIGURATIONS:
        raise ValueError(f"configuration must be one of {CONFIGURATIONS}, got {config!r}")
    if _block_shots is not None and (config != "wide" or _block_shots not in WIDE_BLOCK_SHOTS):
        raise ValueError(f"only \"wide\" takes a block of {WIDE_BLOCK_SHOTS} shots, got {config!r}, {_block_shots}")
    name, groups = config, 1
    if config == "wide" and x.shape[0] > 0:
        shots = _block_shots or wide_block_shots(x.shape[0])
        name, groups = ("wide" if shots == 128 else "wide_32"), shots // 32
    elif config == "per_term_wide":
        groups = per_term_wide_groups(x.shape[0], tables.words)
        name = "per_term_wide_32" if groups == 1 else config
    return _call("tsim_sample_eval", CONFIGURATIONS.index(config), tables, x, count_as or name, groups)


def ablate(tables, x: torch.Tensor, variant: str) -> torch.Tensor:
    """The wide kernel with the stages of ablation ``variant`` (K8)."""
    names = [name for name, _, _ in ABLATION_VARIANTS]
    if variant not in names:
        raise ValueError(f"variant must be one of {names}, got {variant!r}")
    return _call("tsim_sample_eval_ablate", names.index(variant), tables, x, "ablate")


def sample_product_sum(tables, x: torch.Tensor) -> torch.Tensor:
    """(B, P) uint8 parameter rows on a CUDA device -> (B, 2) float32 (re, im)
    of the graph-summed product, for the rung held by ``tables``, in the
    rung's configuration (``tables.per_term``, where set, decides between
    the packed and the per-term kernels in place of the environment's switch)."""
    return launch(tables, x, configuration(tables.num_graphs, tables.per_term))
