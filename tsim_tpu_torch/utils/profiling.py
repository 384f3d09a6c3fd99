"""Profiling: the port's span recorder, and a ``torch.profiler`` trace beside it.

Counterpart of ``tsim_tpu/utils/profiling.py``. The sampler's ``__repr__``
and ``compile_stats`` cover compile-time observability; this adds the
run-time half.

**Spans.** The port marks its layer boundaries with :func:`span`: a call
(``tsim.sample``), its batch plan (``tsim.plan``), each shard's batch step
(``tsim.step``) and the step's capture (``tsim.capture``), the host's wait
for a batch's copy and its move into the result (``tsim.to_host.wait``,
``tsim.to_host.move``), the host's read of the norm deviation
(``tsim.deviation.read``), a postselected chunk's draw, survivor read and
evaluation (``tsim.postsel.draw``, ``.read``, ``.evaluate``), and in set-up
the host compile (``tsim.compile``), the build of the evaluator tables
(``tsim.tables``, with each exact rung's live node-phase terms and those
that ``exact_wide``'s fold takes), the kernels' load (``tsim.kernels.load``)
and the K4 self-test (``tsim.self_test``). Counts ride on a span as its
attributes (``rows``, ``survivors``, ...; :func:`note` sets them once they
are known). Recording is off by default: :func:`span` then checks one flag
and hands back a shared no-op context, reading no clock and recording
nothing. :func:`start` turns it on, :func:`stop` off, handing back what was
recorded:

    from tsim_tpu_torch.utils import profiling

    profiling.start()
    sampler.sample(1 << 22)
    for s in profiling.stop():
        print(s.name, (s.end_ns - s.start_ns) / 1e6, "ms", s.counts)

Each span is one :class:`Span` appended as it closes: its name, id, the id
of the innermost span open around it (its parent, 0 for none), the id of
the ``tsim.sample`` call around it (0 for none), start and end, and counts.
Spans are stamped with ``time.time_ns()``, the clock ``torch.profiler``
(kineto) stamps its host events with, so spans fall on a trace's timeline
as they are (``tests/test_torch_spans.py::test_span_clock_is_the_profilers``
fails where a torch release changes that clock). A span opens no
``record_function``, which costs about as much as a short span lasts. One
host thread drives every card (``sampler.py``), so the recorder takes no
lock; spans opened on other threads would nest wrongly.

**Trace.** :func:`trace` records a block with ``torch.profiler`` and the
recorder together and writes one Chrome/Perfetto file, the spans on the
host thread's track beside the profiler's events; :func:`annotate` marks a
region of one's own as a span:

    from tsim_tpu_torch.utils.profiling import annotate, trace

    with trace("traces/d3"):
        with annotate("sample"):
            sampler.sample(1_000_000)
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

CALL = "tsim.sample"


class Span(NamedTuple):
    name: str
    id: int
    parent: int  # the innermost span open around this one; 0 for none
    call: int  # the ``tsim.sample`` span around this one (or itself); 0 for none
    start_ns: int  # time.time_ns()
    end_ns: int
    counts: dict


_recording = False
_spans: list[Span] = []
_open: list["_OpenSpan"] = []  # innermost last
_ids = itertools.count(1)
_OFF = contextlib.nullcontext()


class _OpenSpan:
    __slots__ = ("name", "counts", "id", "parent", "call", "start")

    def __init__(self, name: str, counts: dict):
        self.name, self.counts = name, counts

    def __enter__(self):
        outer = _open[-1] if _open else None
        self.id = next(_ids)
        self.parent = outer.id if outer else 0
        self.call = (outer.call if outer else 0) or (self.id if self.name == CALL else 0)
        _open.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if _open and _open[-1] is self:
            _open.pop()
        if _recording:
            _spans.append(Span(self.name, self.id, self.parent, self.call, self.start, end, self.counts))
        return False


def span(name: str, **counts):
    """A context that records the enclosed block as a span named ``name``
    with ``counts``, where recording is on; else a shared no-op context."""
    if not _recording:
        return _OFF
    return _OpenSpan(name, counts)


def note(**counts) -> None:
    """Set ``counts`` on the innermost open span (nothing where recording is
    off or no span is open)."""
    if _recording and _open:
        _open[-1].counts.update(counts)


def start() -> None:
    """Turn recording on, with nothing recorded yet."""
    global _recording, _spans
    _spans = []
    _recording = True


def stop() -> list[Span]:
    """Turn recording off; the spans recorded since :func:`start`, in the
    order they closed (again on a second call)."""
    global _recording
    _recording = False
    return _spans


def recording() -> bool:
    return _recording


def annotate(name: str):
    """A region of one's own, recorded as a span (``with annotate("ladder"): ...``)."""
    return span(name)


@contextlib.contextmanager
def trace(log_dir, *, create_perfetto_link: bool = False):
    """Record the enclosed block with ``torch.profiler`` (CPU activity, and
    CUDA activity when a card is visible) and the span recorder, and write
    both into ``log_dir`` as one Chrome trace,
    ``tsim_<pid>_<nanoseconds>.pt.trace.json``: the spans that closed in the
    block go into its ``traceEvents`` on the file's own time base. With
    ``create_perfetto_link`` the file's path is printed with a note to open
    it in Perfetto; nothing is served."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"tsim_{os.getpid()}_{time.time_ns()}.pt.trace.json")
    was_recording = _recording
    if not was_recording:
        start()
    first = len(_spans)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        spans = (_spans if was_recording else stop())[first:]
        prof.export_chrome_trace(path)
        _add_spans(path, spans)
        if create_perfetto_link:
            print(f"trace written to {path}: open it in Perfetto (Open trace file)", flush=True)


def _add_spans(path: str, spans: list[Span]) -> None:
    """Append ``spans`` to the Chrome trace at ``path`` as complete events on
    this thread's track; the file's ``ts`` are microseconds after its
    ``baseTimeNanoseconds`` (0 where it has none)."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid, tid = os.getpid(), threading.get_native_id()
    doc.setdefault("traceEvents", []).extend(
        {"ph": "X", "cat": "tsim", "name": s.name, "pid": pid, "tid": tid,
         "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": {"id": s.id, "parent": s.parent, "call": s.call,
                  **{k: v if isinstance(v, (bool, int, float, str)) else str(v) for k, v in s.counts.items()}}}
        for s in spans
    )
    with open(path, "w") as f:
        json.dump(doc, f)
