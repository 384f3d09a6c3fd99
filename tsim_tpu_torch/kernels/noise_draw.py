"""Wrapper of the noise-draw kernel (``csrc/noise_draw.cu``).

:func:`draw` checks its inputs, allocates the (B, F) uint8 output, launches
on PyTorch's current stream, raises if the launch fails and counts the
launch as ``noise_draw``. There is no fallback: the plain version
(``noise/device_channels.py::DeviceChannelSampler.sample_from_uniforms``)
runs only for CPU tensors, chosen by the caller. The kernel has no
``pl.pallas_call`` counterpart: it replaces the XLA fusion of
``tsim_tpu/noise/device_channels.py:124-176`` inside ``tsim_tpu``'s one-jit
batch step.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

# Launches, counted where each launch succeeds, and the same per device.
launch_counts = {"noise_draw": 0}
device_launch_counts: dict[str, dict[str, int]] = {}


def reset_launch_counts() -> None:
    launch_counts["noise_draw"] = 0
    device_launch_counts.clear()


def table_words(num_channels: int, cdf_entries: int, words: int) -> int:
    """int32 words of a draw table: C + 1 offsets, N CDF entries and
    (N + C) patterns of ``words`` words."""
    return num_channels + 1 + cdf_entries + (cdf_entries + num_channels) * words


def draw(table: torch.Tensor, u: torch.Tensor, cdf_entries: int, words: int, num_f: int) -> torch.Tensor:
    """(B, C) float32 uniforms on a CUDA device -> (B, num_f) uint8 noise
    configurations, from ``table`` (``DeviceChannelSampler``'s int32 draw
    table of ``cdf_entries`` CDF entries and ``words`` words a pattern) on
    the same device."""
    if u.device.type != "cuda":
        raise ValueError(f"the noise-draw kernel takes CUDA tensors, got {u.device}")
    if u.dtype != torch.float32 or u.dim() != 2 or not u.is_contiguous():
        raise ValueError(f"expected contiguous (B, C) float32 uniforms, got {tuple(u.shape)} {u.dtype}")
    B, C = u.shape
    if table.device != u.device or table.dtype != torch.int32 or not table.is_contiguous():
        raise ValueError(f"table on {table.device} ({table.dtype}), uniforms on {u.device}")
    if table.numel() != table_words(C, cdf_entries, words) or not 0 < num_f <= 32 * words:
        raise ValueError(
            f"a table of {table.numel()} words does not hold {C} channels, {cdf_entries} CDF "
            f"entries and {words} words a pattern for {num_f} f bits"
        )
    out = torch.empty((B, num_f), dtype=torch.uint8, device=u.device)
    if B == 0 or C == 0:
        return out.zero_()
    lib = build.load()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tsim_noise_draw(
            ctypes.c_void_p(u.data_ptr()), B, C, ctypes.c_void_p(table.data_ptr()), cdf_entries,
            words, num_f, ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(stream),
        )
    if err != 0:
        msg = lib.tsim_cuda_error_string(err).decode()
        raise RuntimeError(
            f"tsim_noise_draw launch failed on {B} rows of {C} channels, {num_f} f bits: "
            f"cudaError {err}: {msg}"
        )
    launch_counts["noise_draw"] += 1
    device_launch_counts.setdefault(str(u.device), {"noise_draw": 0})["noise_draw"] += 1
    return out
