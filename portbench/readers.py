"""Arithmetic that several per-layer readers share: kernels by name, device
time by kernel set, and a roofline share from the record's work counts."""

from __future__ import annotations

import functools
import re

from . import tracing

F32_EVAL = re.compile(r"(?<![A-Za-z0-9_])sample_eval\w*")
EXACT_EVAL = re.compile(r"(?<![A-Za-z0-9_])(exact_wide|exact_small|approx_wide|approx_small)(?![A-Za-z0-9_])")
NOISE_DRAW = re.compile(r"(?<![A-Za-z0-9_])noise_draw(?![A-Za-z0-9_])")


@functools.lru_cache(maxsize=None)
def matches(pattern: re.Pattern, name: str) -> bool:
    """Whether ``pattern`` finds a kernel's name: searched once a name, as a
    trace repeats a few names a million times."""
    return pattern.search(name) is not None


def kernels(record: dict, pattern: re.Pattern) -> list[tuple]:
    """The traced span's kernel events whose name matches ``pattern``."""
    lo, hi = record["window_us"]
    return [e for e in record["device"]
            if e[4] == "kernel" and lo <= e[2] and e[3] <= hi and matches(pattern, e[0])]


def device_ms(events) -> float:
    return sum(e[3] - e[2] for e in events) / 1e3


def roofline_pct(record: dict, pattern: re.Pattern, least_ms, launches_per_round: int,
                 rows: int) -> float | None:
    """100 x the least time of the work over the device time of the kernels
    that ``pattern`` names. The work is ``rows`` rows through ``least_ms``
    (least ms of one round of launches of a given number of rows), in as
    many rounds as the trace holds launches over ``launches_per_round``;
    each round reads its tables once. None where no such kernel ran."""
    found = kernels(record, pattern)
    if not found or launches_per_round <= 0 or rows <= 0:
        return None
    rounds = len(found) / launches_per_round
    least = rounds * least_ms(rows / rounds)
    return 100.0 * least / device_ms(found)


def step_pct(record: dict) -> float | None:
    """100 x the least time of the traced span's noise draws and
    evaluations together over the traced wall times the cards used."""
    work = record.get("work") or {}
    if not work:
        return None
    least_ms = 0.0
    noise = kernels(record, NOISE_DRAW)
    if noise and record["rows"] > 0:
        least_ms += len(noise) * work["noise_least_ms"](record["rows"] / len(noise))
    evals = kernels(record, F32_EVAL if work["evaluation"] == "f32" else EXACT_EVAL)
    if evals and record["evaluated_rows"] > 0:
        rounds = len(evals) / work["eval_launches"]
        least_ms += rounds * work["eval_least_ms"](record["evaluated_rows"] / rounds)
    span = tracing.window_s(record) * len(record["devices"])
    if not (noise or evals) or span <= 0:
        return None
    return 100.0 * least_ms / 1e3 / span
