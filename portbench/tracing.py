"""The traced run's record: ``torch.profiler`` (CPU and CUDA activity) held
over a steady part of the window, reduced to plain intervals that the
per-layer readers (``metrics/*.py``) and the breakdown read.

Each metric file states its ``SPAN``: (start, end) as shares of the
window's ``--seconds``, (0.1, 1.0) being the window after its first tenth. The profiler is
held over the hull of the cell's metrics' spans, from the first call that
starts after the earliest start to the call that ends after the latest
end, and each reader gets the record cut to its own span
(``span_view``).

The record is a dict:

* ``window_us``: (start, end) of the traced span, on the trace's clock (the
  benchmark's own ``portbench.window`` annotation);
* ``shares``: the same span as shares of the window's ``--seconds``;
* ``device``: (name, device index, start us, end us, kind) of every kernel,
  copy and memset on a card, kind "kernel", "memcpy" or "memset";
* ``host``: (name, thread, start us, end us) of every host event: the
  PyTorch operators, the CUDA runtime calls and the benchmark's own
  ``sample`` annotation around each call;
* ``devices``: the card indices the cell uses;
* ``calls``: each traced call's ``start_us``, ``end_us``, ``rows``,
  ``steps`` (shard steps, the sampler's ``last_batch_steps``) and
  ``evaluated_rows`` (the rows the ladder evaluates);
* ``rows``, ``steps``, ``evaluated_rows``: those summed over the calls
  inside ``window_us``; and ``work``, the least-work counts of ``counts/``.
"""

from __future__ import annotations

from collections import defaultdict

WINDOW = "portbench.window"
CALL = "sample"


def device_kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


class Tracer:
    """``torch.profiler`` prepared in set-up (its start costs seconds, which
    would otherwise fall inside the window) and recording from ``record()``
    to ``stop()``, with the benchmark's window annotation around it."""

    def __init__(self, torch, on_card: bool):
        self._torch = torch
        activities = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        # Step 0 prepares, step 1 records, step 2 stops.
        self.prof = torch.profiler.profile(
            activities=activities, schedule=torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1))
        self.prof.start()
        self._window = None
        self.stopped = None  # the profiler, once stopped

    def record(self) -> None:
        self.prof.step()
        self._window = self._torch.profiler.record_function(WINDOW)
        self._window.__enter__()

    def stop(self) -> None:
        if self.prof is None:
            return
        if self._window is not None:
            self._window.__exit__(None, None, None)
            self._window = None
            self.prof.step()
        self.prof.stop()
        self.stopped, self.prof = self.prof, None


def record_from(prof) -> dict:
    """The record of a ``torch.profiler.profile`` that has stopped, read
    from the profiler's own events (building PyTorch's ``FunctionEvent``
    tree for a trace of tens of seconds takes minutes)."""
    from torch.autograd import DeviceType

    results = prof.profiler.kineto_results
    zero = results.trace_start_ns()
    device, host, window = [], [], None
    names: dict[str, str] = {}  # one string a name, so that its hash is taken once
    for e in results.events():
        name = e.name()
        name = names.setdefault(name, name)
        start, end = (e.start_ns() - zero) / 1e3, (e.end_ns() - zero) / 1e3
        if e.device_type() == DeviceType.CUDA:
            # The profiler mirrors the benchmark's annotations on the card's
            # timeline; they are spans of host calls, not device work.
            if name in (WINDOW, CALL) or e.is_user_annotation():
                continue
            device.append((name, int(e.device_index()), start, end, device_kind(name)))
        else:
            if name == WINDOW:
                window = (start, end)
            host.append((name, int(e.start_thread_id()), start, end))
    if window is None:
        raise RuntimeError("the traced span's annotation is missing from the trace")
    return {"window_us": window, "device": device, "host": host}


def hull(spans) -> tuple[float, float]:
    """The traced part of the window: from the earliest start of ``spans``
    ((start, end) shares of the window) to the latest end."""
    spans = [(float(a), float(b)) for a, b in spans]
    if not all(0.0 <= a < b <= 1.0 for a, b in spans):
        raise ValueError(f"a span is not (start, end) with 0 <= start < end <= 1: {spans}")
    return min(a for a, _ in spans), max(b for _, b in spans)


def calls_on_trace(record: dict, calls: list[dict]) -> list[dict]:
    """``calls`` (the traced calls' counts, in order) with the trace's
    ``start_us`` and ``end_us`` of each call's ``sample`` annotation."""
    spans = sorted((s, e) for name, _, s, e in record["host"] if name == CALL)
    return [dict(c, start_us=s, end_us=e) for c, (s, e) in zip(calls, spans)]


def counts(calls: list[dict]) -> dict:
    return {k: sum(c[k] for c in calls) for k in ("rows", "steps", "evaluated_rows")}


def span_view(record: dict, span) -> dict:
    """The record cut to ``span`` ((start, end) shares of the window): its
    traced span mapped onto the trace's clock, within the traced part, and
    the counts of the calls that lie inside it. The hull's own span is the
    whole record."""
    lo, hi = record["window_us"]
    a, b = record["shares"]
    if b <= a:
        return record
    per_share = (hi - lo) / (b - a)
    start = max(lo, lo + (float(span[0]) - a) * per_share)
    end = min(hi, hi + (float(span[1]) - b) * per_share)
    if (start, end) == (lo, hi):
        return record
    inside = [c for c in record["calls"] if start <= c["start_us"] and c["end_us"] <= end]
    return dict(record, window_us=(start, end), **counts(inside))


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals (a copy of
    ``dev/torch_profile_d3.py::busy_union_us``, on plain pairs)."""
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total


def clipped(record: dict, device: int | None = None) -> list[tuple[float, float]]:
    """The device intervals inside the traced span, of one card or all."""
    lo, hi = record["window_us"]
    return [(max(s, lo), min(e, hi)) for _, d, s, e, _ in record["device"]
            if (device is None or d == device) and e > lo and s < hi]


def window_s(record: dict) -> float:
    lo, hi = record["window_us"]
    return (hi - lo) / 1e6


def busy_s(record: dict, device: int) -> float:
    return union_us(clipped(record, device)) / 1e6


def idle_pct(record: dict, device: int) -> float | None:
    span = window_s(record)
    if span <= 0 or not clipped(record, device):
        return None
    return 100.0 * (1.0 - busy_s(record, device) / span)


def device_ops(record: dict, top: int = 10) -> list[list]:
    """The device operations that took most time: [name, seconds]."""
    lo, hi = record["window_us"]
    by_name: dict[str, float] = defaultdict(float)
    for name, _, s, e, _ in record["device"]:
        if e > lo and s < hi:
            by_name[name] += (min(e, hi) - max(s, lo)) / 1e6
    return [[n, t] for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]


def _host_at(record: dict, t: float) -> str:
    """What the host was doing at ``t``: the benchmark's span around it and
    the innermost host event holding it (on any thread)."""
    holding = [(e - s, name) for name, _, s, e in record["host"]
               if s <= t <= e and name != WINDOW]
    if not holding:
        return "between calls"
    holding.sort()
    inner = holding[0][1]
    outer = CALL if any(name == CALL for _, name in holding) else None
    if outer is None or inner == outer:
        return inner
    return f"{outer}>{inner}"


def idle_gaps(record: dict, device: int, top: int = 10) -> list[list]:
    """The longest stretches in which ``device`` ran nothing, [what the host
    was doing at the stretch's middle, seconds]."""
    lo, hi = record["window_us"]
    gaps, end = [], lo
    for s, e in sorted(clipped(record, device)):
        if s > end:
            gaps.append((s - end, end, s))
        end = max(end, e)
    if hi > end:
        gaps.append((hi - end, end, hi))
    gaps.sort(key=lambda g: (-g[0], g[1]))
    return [[_host_at(record, (a + b) / 2), length / 1e6] for length, a, b in gaps[:top]]
