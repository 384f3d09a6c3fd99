"""Column selection on device (counterpart of ``tsim_tpu/ops/gf2.py``)."""

from __future__ import annotations

import torch


def static_take_columns(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[:, idx]`` for a fixed ``LongTensor`` of columns on ``x``'s device.

    One ``index_select``; ``tsim_tpu``'s one-hot matmul gather worked around
    TPU backends without dynamic gathers.
    """
    return x.index_select(1, idx)
