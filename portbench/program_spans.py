"""The program's own spans, on a traced run's clock, for the per-layer
readers that read them (``metrics/host_move_ms_per_batch.py`` and its kin).

``tsim_tpu_torch.utils.profiling`` records a span (name, start and end on
``time.time_ns()``, counts such as ``rows``) at each of the program's layer
boundaries while its recorder is on. A reader of spans calls
:func:`record_spans` as it is loaded: the harness loads the per-layer readers
of a traced run, and only of a traced run, after the warm-up and before the
window, so the recorder holds every call of the window (and none of the
set-up). After the window :func:`on_trace` gives those spans on the
record's time base, as (name, start us, end us, counts): the recorder's
``tsim.sample`` span of each call lies inside the harness's ``sample``
annotation of that call (``record["calls"]``), so the offset between the
two clocks is the one that puts the traced calls' spans inside their
annotations. A record that carries its spans (``record["spans"]``, on its
time base) is read as it is.

A program without the recorder, as before it had one, gives None, and so
does every reader of spans: the result line leaves their metrics out.
"""

from __future__ import annotations

import bisect

import numpy as np

CALL = "tsim.sample"
# The traced calls' spans must keep this distance to their annotations
# within this much (us, the median deviation): a call's annotation opens some
# tens of us before the call's span, and a pause of the host between the two
# lengthens that for a few calls only.
MAX_DEVIATION_US = 200.0


def _recorder():
    """The program's span recorder, or None where it has none."""
    try:
        from tsim_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not all(hasattr(profiling, f) for f in ("start", "stop", "recording")):
        return None
    return profiling


def record_spans() -> None:
    """Turn the program's span recorder on where it has one and it is off."""
    profiling = _recorder()
    if profiling is not None and not profiling.recording():
        profiling.start()


def aligned(spans, calls: list[dict]) -> list[tuple] | None:
    """``spans`` (the recorder's) as (name, start us, end us, counts) on the
    time base of ``calls`` (the record's traced calls, in order, each with
    the ``start_us`` of its annotation). The run of consecutive
    ``tsim.sample`` spans, one a call, whose starts keep the same distance
    to the calls' starts (their median deviation from it within
    MAX_DEVIATION_US) fixes the offset: the least distance, so that no
    call's span starts before its annotation. None where no run does."""
    starts = np.array(sorted(s.start_ns for s in spans if s.name == CALL), dtype=np.float64) / 1e3
    at = np.array([c["start_us"] for c in calls], dtype=np.float64)
    n = len(at)
    if n == 0 or len(starts) < n:
        return None
    best = None
    for j in range(len(starts) - n + 1):
        d = starts[j : j + n] - at
        deviation = float(np.median(np.abs(d - np.median(d))))
        if best is None or deviation < best[0]:
            best = (deviation, float(d.min()))
    if best[0] > MAX_DEVIATION_US:
        return None
    offset = best[1]
    return [(s.name, s.start_ns / 1e3 - offset, s.end_ns / 1e3 - offset, s.counts) for s in spans]


def on_trace(record: dict) -> list[tuple] | None:
    """The program's spans on the record's time base: ``record["spans"]``
    where it has them, else the recorder's, aligned to the traced calls;
    None where the program has no recorder or nothing lines up."""
    if "spans" in record:
        return record["spans"]
    profiling = _recorder()
    if profiling is None:
        return None
    recorded = profiling.stop()
    return aligned(recorded, record.get("calls") or []) if recorded else None


def inside(record: dict, spans: list[tuple], names) -> list[tuple]:
    """The spans named in ``names`` that lie wholly inside the record's
    traced span."""
    lo, hi = record["window_us"]
    return [s for s in spans if s[0] in names and lo <= s[1] and s[2] <= hi]


def ms(spans: list[tuple]) -> float:
    return sum(s[2] - s[1] for s in spans) / 1e3


def ms_per(record: dict, summed, counted) -> float | None:
    """The time of the spans named in ``summed`` inside the traced span,
    over the number of spans named in ``counted`` there (ms); None where the
    program has no spans or none is counted."""
    spans = on_trace(record)
    if spans is None:
        return None
    n = len(inside(record, spans, counted))
    return ms(inside(record, spans, summed)) / n if n else None


def idle_split(record: dict, spans: list[tuple], device: int) -> dict[str, float]:
    """Seconds in which ``device`` ran nothing inside the traced span, by the
    innermost program span the host was in at each idle stretch's middle
    (the spans of a call nest, so the innermost is the shortest that holds
    the moment), "between calls" outside every ``tsim.sample``; the
    longest first."""
    from portbench import tracing

    calls = sorted((s[1], s[2]) for s in spans if s[0] == CALL)
    starts = [c[0] for c in calls]
    of_call: list[list[tuple]] = [[] for _ in calls]
    for s in spans:
        i = bisect.bisect_right(starts, s[1]) - 1
        if i >= 0 and s[2] <= calls[i][1]:
            of_call[i].append(s)

    def innermost(t: float) -> str:
        i = bisect.bisect_right(starts, t) - 1
        if i < 0 or t > calls[i][1]:
            return "between calls"
        return min((s[2] - s[1], s[0]) for s in of_call[i] if s[1] <= t <= s[2])[1]

    lo, hi = record["window_us"]
    split: dict[str, float] = {}
    end = lo
    for s, e in sorted(tracing.clipped(record, device)) + [(hi, hi)]:
        if s > end:
            name = innermost((end + s) / 2)
            split[name] = split.get(name, 0.0) + (s - end) / 1e6
        end = max(end, e)
    return dict(sorted(split.items(), key=lambda kv: -kv[1]))
