"""Where the time of d3 distillation sampling goes on a CUDA card (tsim_tpu_torch),
or that of 2-check cultivation (``--program cultivation``, in exact mode with
``--evaluation exact``, postselected in f32 mode with ``--postselected``), or
that of 1-check cultivation (``--program cultivation1``, the model's default,
whose ladder is eight launches of the small f32 kernel and one of the wide).

    python3 dev/torch_profile_d3.py [--batch 1048576] [--batches 4] [--out build/profile_d3]
                                    [--program d3|cultivation|cultivation1] [--evaluation f32|exact]
                                    [--postselected] [--mesh K]

1. Stage split of one batch serialised, on the host clock, with
   ``torch.cuda.synchronize()`` after each stage: noise draw (``torch.rand``
   and the noise-draw kernel) and ladder (the sampler's eager
   ``_sample_batch``), the device-to-host copy into pinned memory and the
   host's move into the result array (``_RowsToHost.push`` and ``close``).
   Medians over the batches. ``sample()`` pipelines these stages across
   batches and replays the captured step; their sum is the time of an eager
   batch without either.
2. The same batches through ``sample()``, every batch a replay of the
   captured step (two warm-up batches capture it first), without and with
   ``torch.profiler``: wall time of each, the device's busy share (the union
   of the kernels' and copies' device intervals over the profiled wall
   time, beside their plain sum, which counts twice what the copy stream
   overlaps), and device time by kernel. The Chrome trace and the full table
   go under ``--out``.

``--mesh K`` samples on a mesh of cards 0 .. K - 1, the batch split over
them, and part 1 becomes the host's time by stage of a sharded batch, with
no synchronisation in between (what one host thread spends enqueueing each
shard's batch step, waiting for and moving its rows: the recorder's spans
of graphed calls), summed over the shards, beside the same for one card.

``--postselected`` profiles postselected 2-check cultivation instead
(``chip_smoke.py`` phase 10: the mask over all detectors, both reference
samples): part 2 only, since its chunks do not go through
``_sample_batch``.

Needs a CUDA device and the committed programs.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _self_device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def busy_union_us(events) -> float:
    """Length of the union of the device intervals of ``events`` (us)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total


def stage_split(sampler, B: int, n: int) -> None:
    """Part 1: medians over ``n`` serialised batches of each stage."""
    import torch

    from tsim_tpu_torch.sampler import _RowsToHost

    stages = {k: [] for k in ("noise", "ladder", "d2h", "host")}
    result = np.empty((B, sampler._program.num_outputs), dtype=np.bool_)
    to_host = _RowsToHost(result, sampler.device, B)
    for _ in range(n):
        torch.cuda.synchronize()
        last = [time.perf_counter()]

        def stage(name):
            torch.cuda.synchronize()
            now = time.perf_counter()
            stages[name].append((now - last[0]) * 1e3)
            last[0] = now

        out, _ = sampler._sample_batch(B, stage)
        to_host.push(out, 0)
        stage("d2h")
        to_host.close()
        stage("host")
    total = sum(statistics.median(v) for v in stages.values())
    print(f"stage split, batch {B}, median of {n} (ms):")
    for k, v in stages.items():
        med = statistics.median(v)
        print(f"  {k:7s} {med:9.3f}  ({100 * med / total:5.1f}%)")
    print(f"  {'sum':7s} {total:9.3f}  -> {B / total * 1e3:.0f} shots/s with every stage serialised")


def host_split(sampler, B: int, n: int) -> None:
    """Part 1 with a mesh: medians over ``n`` one-batch ``sample()`` calls,
    graphed as users call it, of the host's time in each of the call's
    spans (``tsim_tpu_torch.utils.profiling``), summed over the shards,
    nothing synchronised in between (the host's enqueue cost, the wait for
    and move of the rows), the call's own time outside them, and its wall
    time to its last row on the host."""
    import torch

    from tsim_tpu_torch.utils import profiling

    names = ("tsim.plan", "tsim.step", "tsim.to_host.wait", "tsim.to_host.move", "tsim.deviation.read")
    spent = {k: [] for k in (*names, "other", "wall")}
    for _ in range(n):
        torch.cuda.synchronize()
        profiling.start()
        try:
            sampler.sample(B, batch_size=B)
        finally:
            spans = profiling.stop()
        (call,) = [s for s in spans if s.name == profiling.CALL]
        for k in names:
            spent[k].append(sum(s.end_ns - s.start_ns for s in spans if s.name == k) / 1e6)
        wall = (call.end_ns - call.start_ns) / 1e6
        spent["other"].append(wall - sum(s.end_ns - s.start_ns for s in spans if s.parent == call.id) / 1e6)
        spent["wall"].append(wall)
    shards = len(sampler._plan_batches(B, B)[1])
    print(f"host time by span, batch {B} over {shards} shards, median of {n} (ms; no sync in between):")
    for k, v in spent.items():
        print(f"  {k:19s} {statistics.median(v):9.3f}")


def main() -> None:
    import torch

    from tsim_tpu_torch.models.exported import cultivation_d3, distillation_d3

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=1 << 20)
    parser.add_argument("--batches", type=int, default=4)
    parser.add_argument("--out", default="build/profile_d3")
    parser.add_argument("--program", choices=("d3", "cultivation", "cultivation1"), default="d3")
    parser.add_argument("--evaluation", choices=("f32", "exact"), default="f32")
    parser.add_argument("--postselected", action="store_true")
    parser.add_argument("--mesh", type=int, default=0, help="cards 0 .. K - 1; 0: one card")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(smi.stdout.strip())
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    B, n = args.batch, args.batches

    if args.postselected or args.program == "cultivation":
        circuit = cultivation_d3(p=0.001, checks=2)
    elif args.program == "cultivation1":
        circuit = cultivation_d3(p=0.001, checks=1)
    else:
        circuit = distillation_d3(p=0.05)
    if args.mesh:
        from tsim_tpu_torch.parallel.shard import ShotMesh

        mesh = ShotMesh([f"cuda:{i}" for i in range(args.mesh)])
        sampler = circuit.compile_detector_sampler(seed=0, mesh=mesh, evaluation=args.evaluation)
    else:
        sampler = circuit.compile_detector_sampler(seed=0, device="cuda", evaluation=args.evaluation)
    kw = {}
    if args.postselected:
        kw = dict(
            postselection_mask=np.ones(sampler._num_detectors, bool), separate_observables=True,
            use_detector_reference_sample=True, use_observable_reference_sample=True,
        )
    print(f"{'postselected ' if args.postselected else ''}{circuit.path.stem}, evaluation {args.evaluation}")
    # Warm-up: kernel build and first launches, then the step's capture.
    sampler.sample(2 * B, batch_size=B, **kw)
    torch.cuda.synchronize()

    if args.mesh:
        host_split(sampler, B, n)
        host_split(circuit.compile_detector_sampler(seed=0, device="cuda:0", mesh=None,
                                                    evaluation=args.evaluation), B, n)
    elif not args.postselected:
        stage_split(sampler, B, n)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sampler.sample(n * B, batch_size=B, **kw)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        sampler.sample(n * B, batch_size=B, **kw)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    # Device-side entries only: a CPU op's self device time repeats the
    # time of the kernels it launched, which appear as entries of their own.
    cuda = torch.autograd.DeviceType.CUDA
    rows = sorted(
        (
            (evt.key, _self_device_us(evt), evt.count)
            for evt in prof.key_averages()
            if evt.device_type == cuda
        ),
        key=lambda r: -r[1],
    )
    summed_us = sum(r[1] for r in rows)
    busy_us = busy_union_us([e for e in prof.events() if e.device_type == cuda])
    print(f"sample({n} x {B}): {plain_wall * 1e3:.1f} ms unprofiled, {prof_wall * 1e3:.1f} ms profiled "
          f"({n * B / plain_wall:.0f} shots/s unprofiled); batch steps {sampler.last_batch_steps}")
    print(f"device busy {busy_us / 1e3:.1f} ms of {prof_wall * 1e3:.1f} ms profiled wall "
          f"= {100 * busy_us / 1e6 / prof_wall:.1f}% (idle {100 - 100 * busy_us / 1e6 / prof_wall:.1f}%); "
          f"device times summed {summed_us / 1e3:.1f} ms")
    print("device time by op/kernel (self, ms, calls):")
    for key, us, count in rows[:15]:
        if us > 0:
            print(f"  {us / 1e3:9.3f}  {count:6d}  {key[:90]}")
    prof.export_chrome_trace(str(out_dir / "trace.json"))
    (out_dir / "key_averages.txt").write_text(
        "".join(f"{us / 1e3:.3f} ms\t{count}\t{key}\n" for key, us, count in rows)
    )
    print(f"wrote {out_dir}/trace.json and key_averages.txt")


if __name__ == "__main__":
    main()
