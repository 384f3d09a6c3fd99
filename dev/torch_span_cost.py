"""What the port's span recorder (``tsim_tpu_torch/utils/profiling.py``)
costs and shows, on the benchmark's cells (``portbench/``), on a CUDA card.

    python3 dev/torch_span_cost.py [--cells cult1.f32 cult2.exact cult2.postsel]
                                   [--rounds 4] [--calls 12] [--trace-seconds 8]

For each cell, built as ``portbench/run.py`` builds it (its frozen circuit,
its traffic's ``sample()`` call, the warm-up until every shard replays):

1. Set-up spans, the recorder on from before the compile: ``tsim.compile``
   (and whether the compile cache held it), ``tsim.kernels.load``,
   ``tsim.self_test``, ``tsim.capture`` (ms each).
2. The cost of recording a call: ``--rounds`` rounds of ``--calls`` calls
   with the recorder off, on, on, off; the median call ms of each side,
   spans a call and a second, and the median and longest ``tsim.plan`` ms.
3. The same calls under ``torch.profiler`` (CPU and CUDA, the benchmark's
   annotations around the window and each call) for ``--trace-seconds``:
   the median and longest ``tsim.plan`` ms there, the card's idle time split by the
   host's innermost span (``program_spans.idle_split``), the span readers'
   metrics, and how far ``program_spans.aligned`` (which finds the clocks'
   offset from the calls) puts the spans from where the trace's own start
   time puts them.

Before the cells, the host's cost of an empty span, with recording on and
off (us, over 200,000). ``--small`` rehearses on the CPU at a tiny size.
Prints one line a measurement and a JSON line at the end.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def span_us(n: int = 200_000) -> dict:
    from tsim_tpu_torch.utils import profiling

    out = {}
    for on in (False, True):
        if on:
            profiling.start()
        t0 = time.perf_counter()
        for _ in range(n):
            with profiling.span("x", rows=1):
                pass
        out["on" if on else "off"] = (time.perf_counter() - t0) / n * 1e6
        profiling.stop()
    return out


def ms(spans, name) -> list[float]:
    return [(s.end_ns - s.start_ns) / 1e6 for s in spans if s.name == name]


def med(values) -> float | None:
    return statistics.median(values) if values else None


def measure(name: str, args) -> dict:
    import torch

    from portbench import cells, program_spans, run, tracing
    from tsim_tpu_torch.circuit import Circuit
    from tsim_tpu_torch.utils import profiling

    cell = cells.load_cell(name)
    traffic = cell.traffic
    device = None
    if args.small:
        traffic = dataclasses.replace(traffic, shots=1 << 13, batch_size=1 << 12, mesh=None)
        device = "cpu"
    on_card = device is None
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    postselected = traffic.postselection is not None
    out = {"cell": name}

    profiling.start()
    t0 = time.perf_counter()
    sampler = Circuit(cell.config.circuit_text).compile_detector_sampler(
        seed=args.seed, device=device, evaluation=traffic.evaluation, mesh=traffic.mesh)
    call = run.make_call(sampler, traffic)
    run.warm_up(sampler, call, postselected)
    sync()
    setup = profiling.stop()
    out["setup_s"] = time.perf_counter() - t0
    compile_spans = [s for s in setup if s.name == "tsim.compile"]
    out["compile_s"] = [(s.end_ns - s.start_ns) / 1e9 for s in compile_spans]
    out["compile_cache_hit"] = [s.counts.get("cache_hit") for s in compile_spans]
    for key in ("tsim.kernels.load", "tsim.self_test", "tsim.capture"):
        out[key + "_ms"] = ms(setup, key)

    calls = {False: [], True: []}
    plan_alone, spans_on = [], 0
    for _ in range(args.rounds):
        for on in (False, True, True, False):
            if on:
                profiling.start()
            for _ in range(args.calls):
                t = time.perf_counter()
                call()
                calls[on].append((time.perf_counter() - t) * 1e3)
            if on:
                spans = profiling.stop()
                spans_on += len(spans)
                plan_alone += ms(spans, "tsim.plan")
    out["call_ms_off"], out["call_ms_on"] = med(calls[False]), med(calls[True])
    out["spans_per_call"] = spans_on / len(calls[True])
    out["spans_per_s"] = spans_on / (sum(calls[True]) / 1e3)
    out["plan_ms_alone"], out["plan_ms_alone_max"] = med(plan_alone), max(plan_alone, default=None)

    activities = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    profiling.start()
    traced = []
    with torch.profiler.record_function(tracing.WINDOW):
        t_end = time.perf_counter() + args.trace_seconds
        while time.perf_counter() < t_end:
            with torch.profiler.record_function(tracing.CALL):
                call()
            traced.append({"rows": traffic.shots, "steps": sum((sampler.last_batch_steps or {}).values())
                           if not postselected else 0, "evaluated_rows": traffic.shots})
    sync()
    spans = profiling.stop()
    prof.stop()
    zero = prof.profiler.kineto_results.trace_start_ns()
    record = tracing.record_from(prof)
    record.update(devices=[torch.cuda.current_device()] if on_card else [0], work=None, shares=(0.0, 1.0),
                  calls=tracing.calls_on_trace(record, traced))
    record.update(tracing.counts(record["calls"]))
    exact = [(s.name, (s.start_ns - zero) / 1e3, (s.end_ns - zero) / 1e3, s.counts) for s in spans]
    found = program_spans.aligned(spans, record["calls"])
    out["align_error_us"] = None if found is None else max(abs(a[1] - b[1]) for a, b in zip(found, exact))
    out["plan_ms_profiled"] = med(ms(spans, "tsim.plan"))
    out["plan_ms_profiled_max"] = max(ms(spans, "tsim.plan"), default=None)
    profiled_mem = [(e - s) / 1e3 for n, _, s, e in record["host"] if n == "cudaMemGetInfo"]
    out["cudaMemGetInfo_ms_profiled"] = med(profiled_mem)
    out["traced_calls"] = len(traced)
    out["traced_s"] = tracing.window_s(record)
    rec = dict(record, spans=exact)
    for metric in ("host_move_ms_per_batch", "host_wait_ms_per_batch", "plan_ms_per_call",
                   "survivor_read_ms_per_chunk.postsel", "host_sync_ms_per_batch", "device_idle_pct"):
        out[metric] = cells.metric_reader(metric).read(rec)
    if on_card:
        out["idle_split_s"] = program_spans.idle_split(rec, exact, record["devices"][0])
        out["busy_s"] = tracing.busy_s(record, record["devices"][0])
    del prof, record, rec, sampler, call
    if on_card:
        torch.cuda.empty_cache()
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cells", nargs="+", default=["cult1.f32", "cult2.exact", "cult2.postsel"])
    parser.add_argument("--rounds", type=int, default=4)
    parser.add_argument("--calls", type=int, default=12)
    parser.add_argument("--trace-seconds", type=float, default=8.0)
    parser.add_argument("--seed", type=int, default=2**31 + 17)
    parser.add_argument("--small", action="store_true", help="rehearse on the CPU at a tiny size")
    args = parser.parse_args()
    import torch

    if not args.small:
        if not torch.cuda.is_available():
            sys.exit("needs a CUDA card (or --small)")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
        print(smi.stdout.strip(), flush=True)
    os.environ.setdefault("TSIM_TPU_COMPILE_CACHE_DIR", str(ROOT / "build" / "portbench" / "compile_cache"))
    results = {"span_us": span_us(), "cells": []}
    print(f"empty span: {results['span_us']}", flush=True)
    for name in args.cells:
        r = measure(name, args)
        results["cells"].append(r)
        for k, v in r.items():
            print(f"{name} {k}: {v}", flush=True)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
