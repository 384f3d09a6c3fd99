"""Column selection and GF(2) products on device (counterpart of ``tsim_tpu/ops/gf2.py``)."""

from __future__ import annotations

import torch


def static_take_columns(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[:, idx]`` for a fixed ``LongTensor`` of columns on ``x``'s device.

    One ``index_select``; ``tsim_tpu``'s one-hot matmul gather worked around
    TPU backends without dynamic gathers.
    """
    return x.index_select(1, idx)


def matmul_gf2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Binary dot products mod 2: ``a`` (T, G, P) and ``b`` (B, P) -> (B, T, G) uint8.

    A float32 product, then mod 2 in float32. Row sums are at most P, so
    the product is exact; the mod must run before any narrowing cast,
    because a float-to-uint8 cast does not wrap and would corrupt the
    parity of sums above 255.
    """
    t, g, _ = a.shape
    if t * g == 0:
        return torch.zeros((b.shape[0], t, g), dtype=torch.uint8, device=b.device)
    sums = b.to(torch.float32) @ a.to(torch.float32).reshape(t * g, -1).T
    return torch.remainder(sums, 2.0).reshape(-1, t, g).to(torch.uint8)
