"""The check that decides ``correct``: the rows that the timed calls
returned, against the exact distribution of the plain reference.

The judged rows are every row of a run of consecutive calls of the window,
``kept_calls`` of them from an offset drawn from the seed. Each row is
packed into its code (bit i is column i), the codes are counted, and the
counts are held against ``N * q``, q being the reference's probability of
each code, by events:

* plain calls: each column's ones, each pair of columns' joint ones, and
  the all-zero row;
* postselected calls (every detector masked): the rows in which no detector
  fired (the survivors; the program leaves the other rows' undrawn outputs
  at 0), and among the survivors each observable's ones.

An event's z is (count - N p) / sqrt(N p (1 - p)); an event whose expected
count, or that of its complement, is under ``MIN_EXPECTED`` is left out, as
its z is far from normal. ``max_abs_z`` is the largest |z|.

``repeated_chunks`` counts aligned blocks of ``CHUNK_ROWS`` rows that
repeat an earlier block of the judged rows exactly: independent draws
never do, and a batch step that leaves its generator unchanged repeats its
batch. Its limit is 0.

``norm_off_share``, in a cell whose traffic asks for exact evaluation:
the share of the window's calls in which the sampler's own monitor of its
probabilities (``last_norm_deviation``: at each rung of each batch, the
probe row's two branch probabilities summed and divided by their
prefix's, less 1) reads other than 0. The reference's probabilities sum to
exactly 1, and so do the exact path's, rounded to float32 once; no count
of rows sees the float32 path's rounding (a relative error near 1e-7),
which puts the monitor one or two float32 steps off 1 in every call.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np

JUDGED_ROWS = 1 << 24  # rows judged a run, at least
MAX_OFFSET = 8  # the first judged call is drawn from [0, MAX_OFFSET)
MIN_EXPECTED = 25.0
CHUNK_ROWS = 4096
# The limit of max_abs_z, set from sound runs' and the control's readings
# on the card (PERF.md, "correct").
MAX_ABS_Z_LIMIT = 17.0
NOTHING_JUDGED = 1e9  # max_abs_z where no event had enough rows: fails
# The limit of norm_off_share, set from the exact path's and the float32
# path's readings on the card (PERF.md, "correct").
NORM_OFF_SHARE_LIMIT = 0.5


def off_share(deviations: list) -> float:
    """The share of ``deviations`` (the sampler's ``last_norm_deviation``
    after each call) that are not 0; a NaN counts as off."""
    if not deviations:
        return 1.0
    return sum(not (float(d or 0.0) == 0.0) for d in deviations) / len(deviations)


def kept_calls(shots: int) -> int:
    return max(2, math.ceil(JUDGED_ROWS / shots))


def first_kept(seed: int) -> int:
    return int(np.random.default_rng(seed).integers(0, MAX_OFFSET))


def codes_of(rows: np.ndarray) -> np.ndarray:
    """(N,) int64 codes of (N, n) bool rows, bit i being column i."""
    packed = np.packbits(rows, axis=1, bitorder="little")
    codes = np.zeros(rows.shape[0], dtype=np.int64)
    for b in range(packed.shape[1]):
        codes |= packed[:, b].astype(np.int64) << (8 * b)
    return codes


def marginal(q: np.ndarray, num_detectors: int, with_observables: bool) -> np.ndarray:
    """The reference's distribution over the columns a call returns:
    every output, or the detectors alone (the low bits)."""
    if with_observables:
        return q
    return q.reshape(-1, 1 << num_detectors).sum(axis=0)


def _z(count: float, n: float, p: float) -> float | None:
    if n * p < MIN_EXPECTED or n * (1 - p) < MIN_EXPECTED:
        return None
    return (count - n * p) / math.sqrt(n * p * (1 - p))


def events(hist: np.ndarray, q: np.ndarray, num_columns: int, num_detectors: int,
           postselected: bool) -> dict[str, float]:
    """z of each event that has enough expected counts, by name."""
    codes = np.arange(len(q))
    bit = [((codes >> i) & 1).astype(bool) for i in range(num_columns)]
    n = float(hist.sum())
    out: dict[str, float] = {}

    def add(name, mask, total, p):
        z = _z(float(hist[mask].sum()), total, p)
        if z is not None:
            out[name] = z

    if postselected:
        survive = (codes & ((1 << num_detectors) - 1)) == 0
        p_survive = float(q[survive].sum())
        add("survivors", survive, n, p_survive)
        n_survive = float(hist[survive].sum())
        for o in range(num_detectors, num_columns):
            if p_survive > 0:
                add(f"survivor_col{o}", survive & bit[o], n_survive, float(q[survive & bit[o]].sum()) / p_survive)
        return out
    for i in range(num_columns):
        add(f"col{i}", bit[i], n, float(q[bit[i]].sum()))
        for j in range(i + 1, num_columns):
            both = bit[i] & bit[j]
            add(f"col{i}&col{j}", both, n, float(q[both].sum()))
    add("zero_row", codes == 0, n, float(q[0]))
    return out


def repeated_chunks(calls: list[np.ndarray]) -> int:
    seen, repeats = set(), 0
    for rows in calls:
        rows = np.ascontiguousarray(rows)
        for start in range(0, rows.shape[0] - CHUNK_ROWS + 1, CHUNK_ROWS):
            digest = hashlib.blake2b(rows[start:start + CHUNK_ROWS].tobytes(), digest_size=16).digest()
            repeats += digest in seen
            seen.add(digest)
    return repeats


def histogram(calls: list[np.ndarray], num_columns: int) -> np.ndarray:
    hist = np.zeros(1 << num_columns, dtype=np.int64)
    for rows in calls:
        hist += np.bincount(codes_of(rows), minlength=1 << num_columns)
    return hist


def checks_of(hist: np.ndarray, q: np.ndarray, num_columns: int, num_detectors: int,
              postselected: bool, repeats: int, off_share: float | None = None) -> dict[str, dict]:
    """The numbers compared, each with its limit, in the order printed;
    ``norm_off_share`` only where ``off_share`` is given."""
    zs = events(hist, q, num_columns, num_detectors, postselected)
    worst = max(zs, key=lambda k: abs(zs[k])) if zs else None
    checks = {
        "max_abs_z": {"value": abs(zs[worst]) if worst else NOTHING_JUDGED, "limit": MAX_ABS_Z_LIMIT,
                      "event": worst, "events": len(zs)},
        "repeated_chunks": {"value": repeats, "limit": 0},
    }
    if off_share is not None:
        checks["norm_off_share"] = {"value": off_share, "limit": NORM_OFF_SHARE_LIMIT}
    return checks


def passed(checks: dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
