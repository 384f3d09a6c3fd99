"""Noise-configuration draws on the device (counterpart of ``tsim_tpu``'s
``noise/device_channels.py``).

Each live channel draws one uniform ``u_c``; its outcome is the number of
CDF entries ``<= u_c`` (an index past the last entry selects nothing), and
the f configuration is the XOR of the selected outcomes' patterns over
the signature matrix. Two paths, as in ``tsim_tpu``:

* packed words, when ``num_f <= 31``: every outcome's f pattern is one
  ``int32`` word; the selected words are gathered and XOR-folded;
* bitplanes otherwise: the outcome indices' binary digits times the
  stacked signature rows, one float32 matmul, mod 2.

The two give the same bits as ``tsim_tpu`` for the same uniforms.
"""

from __future__ import annotations

import numpy as np
import torch


def _xor_fold(words: torch.Tensor) -> torch.Tensor:
    """XOR over the last axis of an int32 tensor, by halving."""
    while words.shape[-1] > 1:
        n = words.shape[-1]
        half = n // 2
        folded = words[..., :half] ^ words[..., half : 2 * half]
        words = torch.cat([folded, words[..., 2 * half :]], dim=-1) if n % 2 else folded
    return words[..., 0]


class DeviceChannelSampler:
    """Draws (batch, num_f) uint8 noise configurations on ``device``."""

    def __init__(self, noise, device):
        self.device = torch.device(device)
        sig = np.asarray(noise.signature_matrix, np.uint8)  # (num_sigs, num_f)
        self.num_f = sig.shape[1]
        live = [ch for ch in noise.channels if 1.0 - float(ch.probs[0]) > 1e-15]
        # Sorted by outcome count (stable), in buckets of equal width, as in tsim_tpu.
        live.sort(key=lambda ch: len(ch.probs))
        self.num_channels = C = len(live)
        self.packed = self.num_f <= 31
        if not live:
            return
        self.max_k = max(len(ch.unique_col_ids) for ch in live)
        self.buckets: list[tuple[int, int, int]] = []
        for ci, ch in enumerate(live):
            o = len(ch.probs)
            if self.buckets and self.buckets[-1][2] == o:
                self.buckets[-1] = (self.buckets[-1][0], ci + 1, o)
            else:
                self.buckets.append((ci, ci + 1, o))
        cdfs = [np.cumsum(np.asarray(ch.probs, np.float64)) for ch in live]
        self._cdf = [
            torch.from_numpy(np.stack(cdfs[s:e]).astype(np.float32)).to(self.device)
            for (s, e, _) in self.buckets
        ]
        if self.packed:
            weights = (1 << np.arange(self.num_f)).astype(np.int64)
            # Per bucket: (O + 1, Cb) pattern words; the extra last row is 0,
            # selected when u lies at or past the channel's last CDF entry.
            self._words = []
            for (s, e, o) in self.buckets:
                w = np.zeros((o + 1, e - s), np.int32)
                for ci in range(s, e):
                    ids = np.asarray(live[ci].unique_col_ids)
                    bits = ((np.arange(o)[:, None] >> np.arange(len(ids))) & 1).astype(np.int64)
                    pat = bits @ sig[ids].astype(np.int64) % 2  # (O, F)
                    w[:o, ci - s] = (pat @ weights).astype(np.int32)
                self._words.append(torch.from_numpy(w.ravel()).to(self.device))
            self._bit_shifts = torch.arange(self.num_f, dtype=torch.int32, device=self.device)
        else:
            s_cat = np.zeros((self.max_k, C, self.num_f), np.float32)
            for ci, ch in enumerate(live):
                ids = np.asarray(ch.unique_col_ids)
                s_cat[: len(ids), ci] = sig[ids]
            self._sig = torch.from_numpy(s_cat.reshape(self.max_k * C, self.num_f)).to(self.device)
            self._plane_shifts = torch.arange(self.max_k, dtype=torch.int32, device=self.device)

    @property
    def peak_bytes_per_shot(self) -> int:
        """Bytes a shot that :meth:`sample` holds at its peak, counted from
        the shapes it allocates, its result included. The (B, C) float32
        uniforms and int32 outcome indices stay to the end; beside them the
        largest of

        * a bucket's compare, (B, Cb, O) bool, and the int32 copy of it that
          a sum with ``dtype`` makes (5 bytes an entry);
        * packed: the gather's (B, Cb) index arithmetic (int32, int32, int64)
          beside the words picked so far; the picked words, their
          concatenation and the XOR fold's two halves; the picked words and
          the (B, num_f) int32 shift, its mask and the uint8 result;
        * bitplanes: the concatenated indices; the (B, k, C) int32 planes
          with their shift or their float32 copy, and the (B, num_f) float32
          counts, their int32 cast, its mask and the uint8 result.

        The same code runs on the CPU and on a card, so the count holds on
        both."""
        C, F = self.num_channels, self.num_f
        if C == 0:
            return F
        compare = 5 * max((e - s) * o for s, e, o in self.buckets)
        if self.packed:
            rest = max(4 * C + 16 * max(e - s for s, e, _ in self.buckets), 12 * C + 8, 4 * C + 9 * F + 4)
        else:
            rest = max(4 * C, 8 * self.max_k * C + 13 * F)
        return 8 * C + max(compare, rest)

    def sample(self, generator: torch.Generator, batch: int) -> torch.Tensor:
        """Draw (batch, num_f) uint8 configurations from ``generator``."""
        if self.num_channels == 0:
            return torch.zeros((batch, self.num_f), dtype=torch.uint8, device=self.device)
        u = torch.rand(
            (batch, self.num_channels), generator=generator, device=self.device,
            dtype=torch.float32,
        )
        return self.sample_from_uniforms(u)

    def sample_from_uniforms(self, u: torch.Tensor) -> torch.Tensor:
        """Noise configurations for given (batch, num_channels) float32 uniforms."""
        batch = u.shape[0]
        if self.num_channels == 0:
            return torch.zeros((batch, self.num_f), dtype=torch.uint8, device=u.device)
        # Outcome index per channel: how many CDF entries are <= u.
        idx = [
            (u[:, s:e, None] >= cdf[None]).sum(dim=2, dtype=torch.int32)
            for (s, e, _), cdf in zip(self.buckets, self._cdf)
        ]
        if self.packed:
            picked = []
            for (s, e, _), i, words in zip(self.buckets, idx, self._words):
                cols = torch.arange(e - s, dtype=torch.int32, device=u.device)
                picked.append(words[(i * (e - s) + cols).long()])
            acc = _xor_fold(torch.cat(picked, dim=1))  # (B,)
            return ((acc[:, None] >> self._bit_shifts) & 1).to(torch.uint8)
        idx = torch.cat(idx, dim=1)  # (B, C)
        planes = (idx[:, None, :] >> self._plane_shifts[None, :, None]) & 1  # (B, k, C)
        x = planes.reshape(batch, -1).to(torch.float32)
        counts = x @ self._sig  # (B, F), integers below 2^24: exact in f32
        return (counts.to(torch.int32) & 1).to(torch.uint8)
