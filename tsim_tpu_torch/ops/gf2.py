"""GF(2) linear algebra: basis extraction on the host, column selection and
GF(2) products on device (counterpart of ``tsim_tpu/ops/gf2.py``)."""

from __future__ import annotations

import numpy as np
import torch


def find_basis(vectors: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Greedy GF(2) row-reduction: ``V = T @ B (mod 2)``.

    Returns ``(basis, transform)`` where ``basis`` is the subset of rows of
    ``V`` (in first-seen order) that are linearly independent, and
    ``transform[i]`` expresses row i of ``V`` over that basis.

    Bit-packed elimination over uint64 words; rows up to ~10^5 columns are
    fine host-side.
    """
    vecs = np.asarray(vectors, dtype=np.uint8)
    n, d = vecs.shape
    words = max(1, (d + 63) // 64)
    packed = np.zeros((n, words), dtype=np.uint64)
    for w in range(words):
        chunk = vecs[:, w * 64 : (w + 1) * 64]
        weights = (np.uint64(1) << np.arange(chunk.shape[1], dtype=np.uint64))
        packed[:, w] = (chunk.astype(np.uint64) * weights[None, :]).sum(axis=1)

    basis_rows: list[int] = []
    reduced: list[np.ndarray] = []  # reduced basis vectors (packed)
    pivots: list[int] = []
    expansions: list[np.ndarray] = []  # expansion of each reduced vec over basis
    t_rows: list[np.ndarray] = []

    def _pivot(row: np.ndarray) -> int:
        for w in range(words):
            if row[w]:
                x = int(row[w])
                return w * 64 + ((x & -x).bit_length() - 1)
        return -1

    for idx in range(n):
        v = packed[idx].copy()
        dep = np.zeros(len(basis_rows) + 1, dtype=np.uint8)
        for j, b in enumerate(reduced):
            p = pivots[j]
            if (v[p >> 6] >> np.uint64(p & 63)) & np.uint64(1):
                v ^= b
                e = expansions[j]
                dep[: len(e)] ^= e
        if v.any():
            basis_rows.append(idx)
            reduced.append(v)
            pivots.append(_pivot(v))
            dep = dep.copy()
            dep[len(basis_rows) - 1] = 1
            expansions.append(dep[: len(basis_rows)])
            t = np.zeros(len(basis_rows), dtype=np.uint8)
            t[-1] = 1
            t_rows.append(t)
        else:
            t_rows.append(dep[: len(basis_rows)].copy())

    rank = len(basis_rows)
    transform = np.zeros((n, rank), dtype=np.uint8)
    for i, row in enumerate(t_rows):
        transform[i, : len(row)] = row
    return vecs[basis_rows], transform



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
