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

The two give the same bits as ``tsim_tpu`` for the same uniforms. They
are the plain version (:meth:`DeviceChannelSampler.sample_from_uniforms`),
which runs for CPU tensors. On a card one hand-written kernel
(``kernels/csrc/noise_draw.cu``) draws from one table for both paths
(:func:`draw_table`): each live channel's float32 CDF and, for each of its
outcomes, its f pattern as W = ceil(num_f / 32) words, XORed over the
channels; XOR gives the bits the parity of the bitplane path's sum gives.
:func:`read_draw_table` reads that table on the host as the kernel does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import noise_draw as _kernel


def _xor_fold(words: torch.Tensor) -> torch.Tensor:
    """XOR over the last axis of an int32 tensor, by halving."""
    while words.shape[-1] > 1:
        n = words.shape[-1]
        half = n // 2
        folded = words[..., :half] ^ words[..., half : 2 * half]
        words = torch.cat([folded, words[..., 2 * half :]], dim=-1) if n % 2 else folded
    return words[..., 0]


def _patterns(ch, sig: np.ndarray, packed: bool) -> np.ndarray:
    """(O + 1, num_f) uint8 f patterns of ``ch``'s outcomes 0 .. O, as the
    plain version selects them: outcome o gives ``bits(o) @ sig[ids] mod 2``
    over the channel's ``len(ids)`` binary digits; outcome O (u at or past
    the last CDF entry) gives 0 on the packed path and that same formula on
    the bitplane path (0 too wherever O = 2^len(ids))."""
    ids = np.asarray(ch.unique_col_ids)
    o = len(ch.probs)
    bits = ((np.arange(o + 1)[:, None] >> np.arange(len(ids))) & 1).astype(np.int64)
    pat = (bits @ sig[ids].astype(np.int64) % 2).astype(np.uint8)
    if packed:
        pat[o] = 0
    return pat


def draw_table(live, sig: np.ndarray, packed: bool) -> tuple[np.ndarray, int, int]:
    """The noise-draw kernel's table of the ``live`` channels (in the
    sampler's order) over the signature matrix ``sig``: (flat int32 table,
    N CDF entries, W words a pattern). The table holds C + 1 offsets (the
    CDF entries before each channel), the N float32 CDF entries (each
    channel's float64 cumsum cast to float32, as the plain version holds
    it) and, for each channel, its O + 1 patterns (:func:`_patterns`) of W
    little-endian int32 words each: f bit j is bit j % 32 of word j // 32."""
    num_f = sig.shape[1]
    words = max(1, -(-num_f // 32))
    cdfs = [np.cumsum(np.asarray(ch.probs, np.float64)).astype(np.float32) for ch in live]
    offsets = np.concatenate([[0], np.cumsum([len(c) for c in cdfs])]).astype(np.int32)
    padded = np.zeros((0, 32 * words), np.uint8)
    if live:
        padded = np.concatenate([_patterns(ch, sig, packed) for ch in live])
        padded = np.pad(padded, ((0, 0), (0, 32 * words - num_f)))
    weights = (np.uint64(1) << np.arange(32, dtype=np.uint64))
    packed_words = (padded.reshape(-1, words, 32).astype(np.uint64) * weights).sum(axis=2)
    cdf = np.concatenate(cdfs) if cdfs else np.zeros(0, np.float32)
    table = np.concatenate([
        offsets, cdf.view(np.int32), packed_words.astype(np.uint32).view(np.int32).ravel()
    ])
    return table, int(offsets[-1]), words


def read_draw_table(table: np.ndarray, num_channels: int, num_f: int, u: np.ndarray) -> np.ndarray:
    """The plain reader of a :func:`draw_table` table: (B, C) float32
    uniforms -> (B, num_f) uint8, shot by shot as the kernel reads it (the
    outcome is the count of CDF entries <= u, in float32; the patterns'
    words XORed over the channels)."""
    C = num_channels
    words = max(1, -(-num_f // 32))
    offsets = table[: C + 1]
    n = int(offsets[-1])
    cdf = table[C + 1 : C + 1 + n].view(np.float32)
    patterns = table[C + 1 + n :].view(np.uint32).reshape(n + C, words)
    u = np.asarray(u, np.float32)
    acc = np.zeros((u.shape[0], words), np.uint32)
    for c in range(C):
        lo, hi = int(offsets[c]), int(offsets[c + 1])
        k = (u[:, c, None] >= cdf[None, lo:hi]).sum(axis=1)
        acc ^= patterns[lo + c + k]
    f = np.arange(num_f)
    return ((acc[:, f // 32] >> (f % 32).astype(np.uint32)) & 1).astype(np.uint8)


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
        # The kernel's table (draw_table), on the host and on the device.
        self.table, self.cdf_entries, self.words = draw_table(live, sig, self.packed)
        self._table = torch.from_numpy(self.table).to(self.device)
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

    def peak_bytes_per_shot(self, device) -> int:
        """Bytes a shot that :meth:`sample` holds at its peak on ``device``,
        counted from the shapes it allocates, its result included.

        On a card, the (B, C) float32 uniforms and the kernel's (B, num_f)
        uint8 result: 4C + num_f.

        On the CPU (the plain version), the (B, C) float32 uniforms and int32
        outcome indices stay to the end; beside them the largest of

        * a bucket's compare, (B, Cb, O) bool, and the int32 copy of it that
          a sum with ``dtype`` makes (5 bytes an entry);
        * packed: the gather's (B, Cb) index arithmetic (int32, int32, int64)
          beside the words picked so far; the picked words, their
          concatenation and the XOR fold's two halves; the picked words and
          the (B, num_f) int32 shift, its mask and the uint8 result;
        * bitplanes: the concatenated indices; the (B, k, C) int32 planes
          with their shift or their float32 copy, and the (B, num_f) float32
          counts, their int32 cast, its mask and the uint8 result.

        The plain version would hold the same on a card, where it does not
        run."""
        C, F = self.num_channels, self.num_f
        if C == 0:
            return F
        if torch.device(device).type != "cpu":
            return 4 * C + F
        compare = 5 * max((e - s) * o for s, e, o in self.buckets)
        if self.packed:
            rest = max(4 * C + 16 * max(e - s for s, e, _ in self.buckets), 12 * C + 8, 4 * C + 9 * F + 4)
        else:
            rest = max(4 * C, 8 * self.max_k * C + 13 * F)
        return 8 * C + max(compare, rest)

    def sample(self, generator: torch.Generator, batch: int) -> torch.Tensor:
        """Draw (batch, num_f) uint8 configurations from ``generator``: one
        (batch, C) float32 ``torch.rand`` on the sampler's device, then
        :meth:`from_uniforms`."""
        if self.num_channels == 0:
            return torch.zeros((batch, self.num_f), dtype=torch.uint8, device=self.device)
        u = torch.rand(
            (batch, self.num_channels), generator=generator, device=self.device,
            dtype=torch.float32,
        )
        return self.from_uniforms(u)

    def from_uniforms(self, u: torch.Tensor) -> torch.Tensor:
        """Noise configurations for given (batch, num_channels) float32
        uniforms, chosen by their device: the kernel
        (``kernels/noise_draw.py``) for a CUDA tensor, which raises if it
        cannot be built or launched, the plain version
        (:meth:`sample_from_uniforms`) for a CPU tensor."""
        if u.device.type == "cpu":
            return self.sample_from_uniforms(u)
        if self.num_channels == 0 or self.num_f == 0:
            return torch.zeros((u.shape[0], self.num_f), dtype=torch.uint8, device=u.device)
        return _kernel.draw(self._table, u.contiguous(), self.cdf_entries, self.words, self.num_f)

    def sample_from_uniforms(self, u: torch.Tensor) -> torch.Tensor:
        """Noise configurations for given (batch, num_channels) float32
        uniforms: the plain version, the CPU's path (on a card only as the
        kernel's yardstick)."""
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
