"""Pauli noise channels: probability tables, simplification, host sampler.

Semantics match reference ``tsim/noise/channels.py`` (bit layouts, the
channel-simplification algebra, and geometric-skip sampling) so circuits and
tests behave identically; the implementation is vectorized numpy throughout.

Bit-layout conventions (little-endian: probs index ``i`` has bit ``b`` set
iff ``(i >> b) & 1``):

* ``error_probs(p)``: 1 bit, [1-p, p].
* ``pauli_channel_1_probs``: bit0 = Z component, bit1 = X component.
* ``pauli_channel_2_probs``: bit0 = Z_i, bit1 = X_i, bit2 = Z_j, bit3 = X_j.
* ``heralded_pauli_channel_1_probs``: bit0 = herald, bit1 = Z, bit2 = X.
* ``correlated_error_probs``: mutually exclusive chain; at most one bit set.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Channel:
    """Distribution over error bit-patterns plus per-bit column signatures."""

    probs: np.ndarray
    unique_col_ids: tuple[int, ...]

    def __post_init__(self) -> None:
        tol = 1e-6
        if np.any(self.probs < -tol) or np.any(self.probs > 1.0 + tol):
            raise ValueError(f"Probabilities must lie in [0, 1], but got: {self.probs}")
        if not np.isclose(np.sum(self.probs), 1.0):
            raise ValueError(
                f"Probabilities must sum to 1, but got: {self.probs} "
                f"(sum {np.sum(self.probs)})"
            )

    @property
    def num_bits(self) -> int:
        return int(np.log2(len(self.probs)))


def error_probs(p: float) -> np.ndarray:
    return np.array([1 - p, p], dtype=np.float64)


def pauli_channel_1_probs(px: float, py: float, pz: float) -> np.ndarray:
    return np.array([1 - px - py - pz, pz, px, py], dtype=np.float64)


def pauli_channel_2_probs(*ps: float) -> np.ndarray:
    """15 probabilities in Stim order: pix, piy, piz, pxi, pxx, pxy, pxz,
    pyi, pyx, pyy, pyz, pzi, pzx, pzy, pzz."""
    (pix, piy, piz, pxi, pxx, pxy, pxz, pyi, pyx, pyy, pyz, pzi, pzx, pzy, pzz) = ps
    probs = np.zeros(16, dtype=np.float64)
    name_to_p = {
        ("I", "X"): pix, ("I", "Y"): piy, ("I", "Z"): piz,
        ("X", "I"): pxi, ("X", "X"): pxx, ("X", "Y"): pxy, ("X", "Z"): pxz,
        ("Y", "I"): pyi, ("Y", "X"): pyx, ("Y", "Y"): pyy, ("Y", "Z"): pyz,
        ("Z", "I"): pzi, ("Z", "X"): pzx, ("Z", "Y"): pzy, ("Z", "Z"): pzz,
    }
    bit = {"I": (0, 0), "Z": (1, 0), "X": (0, 1), "Y": (1, 1)}
    for (pi_, pj), p in name_to_p.items():
        zi, xi = bit[pi_]
        zj, xj = bit[pj]
        probs[zi + 2 * xi + 4 * zj + 8 * xj] = p
    probs[0] = 1 - sum(ps)
    return probs


def heralded_pauli_channel_1_probs(
    pi: float, px: float, py: float, pz: float
) -> np.ndarray:
    probs = np.zeros(8, dtype=np.float64)
    probs[0] = 1 - pi - px - py - pz
    probs[1] = pi  # herald only
    probs[3] = pz  # herald + Z
    probs[5] = px  # herald + X
    probs[7] = py  # herald + Y (= X and Z bits)
    return probs


def correlated_error_probs(probabilities: list[float]) -> np.ndarray:
    k = len(probabilities)
    probs = np.zeros(2**k, dtype=np.float64)
    stay = 1.0
    for i, p in enumerate(probabilities):
        probs[1 << i] = stay * p
        stay *= 1 - p
    probs[0] = stay
    return probs


# ------------------------------------------------------------ simplification

def xor_convolve(probs_a: np.ndarray, probs_b: np.ndarray) -> np.ndarray:
    """P(A xor B = o); O(n^2) is fine for n <= 16."""
    n = len(probs_a)
    if len(probs_b) != n:
        raise ValueError("Both channels must have same number of outcomes")
    idx = np.arange(n)
    xor_table = idx[:, None] ^ idx[None, :]
    out = np.zeros(n, dtype=np.float64)
    np.add.at(out, xor_table, probs_a[:, None] * probs_b[None, :])
    return out


def _probs_tensor(ch: Channel) -> np.ndarray:
    # Fortran order: axis i corresponds to little-endian bit i.
    return ch.probs.reshape((2,) * ch.num_bits, order="F")


def reduce_null_bits(
    channels: list[Channel], null_col_id: int | None = None
) -> list[Channel]:
    """Marginalize out bits mapped to the all-zero transform column."""
    if null_col_id is None:
        return channels
    out: list[Channel] = []
    for ch in channels:
        keep = [i for i, c in enumerate(ch.unique_col_ids) if c != null_col_id]
        if not keep:
            continue
        if len(keep) == ch.num_bits:
            out.append(ch)
            continue
        drop = tuple(i for i in range(ch.num_bits) if i not in keep)
        t = _probs_tensor(ch).sum(axis=drop)
        out.append(
            Channel(
                probs=t.reshape(2 ** len(keep), order="F"),
                unique_col_ids=tuple(ch.unique_col_ids[i] for i in keep),
            )
        )
    return out


def normalize_channels(channels: list[Channel]) -> list[Channel]:
    """Sort column ids per channel, permuting the probability tensor."""
    out: list[Channel] = []
    for ch in channels:
        ids = np.asarray(ch.unique_col_ids)
        perm = np.argsort(ids, stable=True)
        t = _probs_tensor(ch).transpose(perm)
        out.append(
            Channel(
                probs=t.reshape(len(ch.probs), order="F"),
                unique_col_ids=tuple(int(x) for x in ids[perm]),
            )
        )
    return out


def fold_duplicate_channel_bits(channels: list[Channel]) -> list[Channel]:
    """XOR-fold bits that share the same column signature."""
    out: list[Channel] = []
    for ch in channels:
        old = ch.unique_col_ids
        new = tuple(dict.fromkeys(old))
        if len(new) == len(old):
            out.append(ch)
            continue
        pos = {c: p for p, c in enumerate(new)}
        n_old = len(ch.probs)
        idx = np.arange(n_old)
        new_idx = np.zeros(n_old, dtype=np.int64)
        for old_pos, col in enumerate(old):
            new_idx ^= (((idx >> old_pos) & 1) << pos[col])
        probs = np.zeros(2 ** len(new), dtype=np.float64)
        np.add.at(probs, new_idx, ch.probs)
        out.append(Channel(probs=probs, unique_col_ids=new))
    return out


def expand_channel(channel: Channel, target_col_ids: tuple[int, ...]) -> Channel:
    """Expand a channel's distribution onto a sorted superset signature."""
    src = channel.unique_col_ids
    if src != tuple(sorted(src)):
        raise ValueError("Source must be sorted")
    if target_col_ids != tuple(sorted(target_col_ids)):
        raise ValueError("Target must be sorted")
    if len(set(target_col_ids)) != len(target_col_ids):
        raise ValueError("Target must not contain duplicates")
    if not set(src) < set(target_col_ids):
        raise ValueError("Source must be strict subset")
    pos = {c: target_col_ids.index(c) for c in src}
    n_old = len(channel.probs)
    idx = np.arange(n_old)
    new_idx = np.zeros(n_old, dtype=np.int64)
    for src_pos, col in enumerate(src):
        new_idx ^= (((idx >> src_pos) & 1) << pos[col])
    probs = np.zeros(2 ** len(target_col_ids), dtype=np.float64)
    np.add.at(probs, new_idx, channel.probs)
    return Channel(probs=probs, unique_col_ids=tuple(target_col_ids))


def merge_identical_channels(channels: list[Channel]) -> list[Channel]:
    groups: dict[tuple[int, ...], list[Channel]] = {}
    for ch in channels:
        groups.setdefault(ch.unique_col_ids, []).append(ch)
    out: list[Channel] = []
    for ids, group in groups.items():
        probs = group[0].probs.copy()
        for ch in group[1:]:
            probs = xor_convolve(probs, ch.probs)
        out.append(Channel(probs=probs, unique_col_ids=ids))
    return out


def absorb_subset_channels(channels: list[Channel], max_bits: int = 4) -> list[Channel]:
    channels = sorted(channels, key=lambda c: -len(c.unique_col_ids))
    out: list[Channel] = []
    absorbed: set[int] = set()
    for i, ci in enumerate(channels):
        if i in absorbed:
            continue
        set_i = set(ci.unique_col_ids)
        probs = ci.probs.copy()
        for j in range(i + 1, len(channels)):
            if j in absorbed:
                continue
            cj = channels[j]
            if set(cj.unique_col_ids) < set_i and len(set_i) <= max_bits:
                probs = xor_convolve(probs, expand_channel(cj, ci.unique_col_ids).probs)
                absorbed.add(j)
        out.append(Channel(probs=probs, unique_col_ids=ci.unique_col_ids))
    return out


def simplify_channels(
    channels: list[Channel], max_bits: int = 4, null_col_id: int | None = None
) -> list[Channel]:
    channels = reduce_null_bits(channels, null_col_id)
    channels = normalize_channels(channels)
    channels = fold_duplicate_channel_bits(channels)
    channels = merge_identical_channels(channels)
    channels = absorb_subset_channels(channels, max_bits)
    return channels


# ------------------------------------------------------------------ sampler

class ChannelSampler:
    """Samples all channels and maps e-bits to the reduced f basis.

    ``f = error_transform @ e (mod 2)``. Channels whose columns coincide are
    folded/merged/absorbed; sampling uses geometric-skip draws so cost scales
    with the number of *fired* channels, not shots x channels.
    """

    def __init__(
        self,
        channel_probs: list[np.ndarray],
        error_transform: np.ndarray,
        seed: int | None = None,
    ):
        error_transform = np.asarray(error_transform, dtype=np.uint8)
        if error_transform.size == 0:
            num_f = error_transform.shape[0]
            num_e = error_transform.shape[1] if error_transform.ndim == 2 else 0
            error_transform = error_transform.reshape(num_f, num_e)
        unique_cols, inverse = np.unique(error_transform, axis=1, return_inverse=True)
        signature_matrix = unique_cols.T  # (num_signatures, num_f)
        zero_cols = np.flatnonzero(np.all(unique_cols == 0, axis=0))
        null_col_id = int(zero_cols[0]) if len(zero_cols) else None

        channels: list[Channel] = []
        off = 0
        inverse = np.asarray(inverse).ravel()
        for probs in channel_probs:
            k = int(np.log2(len(probs)))
            ids = tuple(int(inverse[off + i]) for i in range(k))
            channels.append(Channel(probs=np.asarray(probs, np.float64), unique_col_ids=ids))
            off += k

        self.channels = simplify_channels(channels, null_col_id=null_col_id)
        self.signature_matrix = signature_matrix.astype(np.uint8)
        self._rng = np.random.default_rng(
            seed if seed is not None else np.random.default_rng().integers(0, 2**30)
        )
        self._sparse_data = self._precompute_sparse(self.channels, self.signature_matrix)

    @staticmethod
    def _precompute_sparse(channels, signature_matrix):
        data = []
        for ch in channels:
            probs = ch.probs.astype(np.float64)
            p_fire = 1.0 - float(probs[0])
            n = len(probs)
            if p_fire <= 1e-15 or n <= 1:
                continue
            cond_cdf = np.cumsum(probs[1:] / p_fire)
            cond_cdf /= cond_cdf[-1]
            ids = np.asarray(ch.unique_col_ids)
            k = len(ids)
            outcomes = np.arange(1, n)
            bits = ((outcomes[:, None] >> np.arange(k)) & 1).astype(np.uint8)
            xor_patterns = (bits @ signature_matrix[ids] % 2).astype(np.uint8)
            data.append((p_fire, cond_cdf, xor_patterns))
        return data

    def sample(self, num_samples: int = 1) -> np.ndarray:
        num_f = self.signature_matrix.shape[1]
        result = np.zeros((num_samples, num_f), dtype=np.uint8)
        for p_fire, cond_cdf, xor_pats in self._sparse_data:
            expected = num_samples * p_fire
            sigma = np.sqrt(expected * (1.0 - p_fire))
            n_draws = int(expected + 7.0 * sigma) + 100
            positions = np.cumsum(self._rng.geometric(p_fire, size=n_draws)) - 1
            positions = positions[positions < num_samples]
            if len(positions) == 0:
                continue
            outcome_idx = np.searchsorted(cond_cdf, self._rng.uniform(size=len(positions)))
            np.bitwise_xor.at(result, positions, xor_pats[outcome_idx])
        return result
