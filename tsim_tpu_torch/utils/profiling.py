"""Profiling hooks: a ``torch.profiler`` trace around sampling runs.

Counterpart of ``tsim_tpu/utils/profiling.py``. The sampler's ``__repr__``
and ``compile_stats`` cover compile-time observability; this adds the
run-time half: a context manager that records the host's activity, and the
card's where one is present, into a Chrome/Perfetto trace file.

    from tsim_tpu_torch.utils.profiling import annotate, trace

    with trace("traces/d3"):
        with annotate("sample"):
            sampler.sample(1_000_000)
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir, *, create_perfetto_link: bool = False):
    """Record the enclosed block with ``torch.profiler`` (CPU activity, and
    CUDA activity when a card is visible) and write it into ``log_dir`` as a
    Chrome trace, ``tsim_<pid>_<nanoseconds>.pt.trace.json``. With
    ``create_perfetto_link`` the file's path is printed with a note to open
    it in Perfetto; nothing is served."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"tsim_{os.getpid()}_{time.time_ns()}.pt.trace.json")
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(path)
        if create_perfetto_link:
            print(f"trace written to {path}: open it in Perfetto (Open trace file)", flush=True)


def annotate(name: str):
    """Named region inside a trace (``with annotate("ladder"): ...``)."""
    return torch.profiler.record_function(name)
