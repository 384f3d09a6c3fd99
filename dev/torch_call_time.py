"""Time ``sample()`` calls of the port's samplers on a CUDA card
(tsim_tpu_torch), for one tree or for two in turns.

    python3 dev/torch_call_time.py [--tree .] [--reps 30] [--paths]
    python3 dev/torch_call_time.py --compare build/parent . [--paths | --defaults | --first]
    python3 dev/torch_call_time.py --first [--profile]

By default, one-batch calls of d3 distillation's f32 detector sampler: for
1024, 16,384 and 2^20 shots, one sampler makes a warm-up call and then
``--reps`` calls of ``sampler.sample(shots)`` with the default batch size,
which is one batch at these counts (two warm-up calls: the second captures
the batch step, which the timed calls replay); each call is timed on the host's clock
(it returns a host array, so it ends synchronised). Printed: the median,
least and greatest wall time in ms.

With ``--paths``, the sampling paths of ``chip_smoke.py``'s phases 4, 7, 10
and 12, each from its committed program as those phases sample it: d3
distillation f32 (8 * 2^20 shots with observables), 1-check cultivation f32
(4 * 2^20), postselected 2-check cultivation f32 (4 * 2^20, every detector
postselected, both reference samples) and 2-check cultivation in exact mode
(4 * 2^20), all at ``batch_size=2**20``. One sampler a path makes a
warm-up call of two batches (the second captures the batch step where the
tree captures one), then ``--reps`` calls (default 3), each timed on the host's
clock to a ``torch.cuda.synchronize()``. Printed: the median, least and
greatest shots/s.

With ``--defaults``, the same paths and noisy grown cultivation
(``models.cultivation_d3_grown(p=0.001, checks=2)``, compiled on this host;
f32 and exact) with no ``batch_size``, as a user calls ``sample()``, and at
``batch_size=2**20``, in turns, 2^22 shots a call: the default batch's rate
beside the explicit one's, and the default batch the tree chose
(``_plan_batches``; of the plain path, also for the postselected one). Set
``TSIM_TPU_COMPILE_CACHE_DIR`` to compile grown cultivation once a tree.

With ``--first``, the one-time cost of a sampler's first call: for d3 f32,
1-check f32, 2-check exact and grown f32, in a process whose kernels are
built and self-tested (a first sampler of the path makes one call and is
dropped), ``--reps`` fresh samplers (default 3) each make one call of
4 * 2^20 shots at ``batch_size=2**20``, then a second one, and (where the
tree captures) a third after ``_drop_graphs()``, which warms up and
captures again as ``chip_smoke.py``'s phases 25 and 27 do. Printed per
path: the three calls' shots/s and the third's capture enqueue ms, and, of the first
call, the host's time in Python's garbage collector (``gc.callbacks``), the
caching allocator's new segments and retries (``torch.cuda.memory_stats``:
cudaMalloc calls and the frees that make room), and, where the tree captures
its batch step, the host ms of the capture's enqueue (and the CPU ms of
the calling thread in it, which tells work from waiting), of
``capture_end`` (the graph's instantiation) and of the first replay. With
``--profile`` too, each first call runs under ``torch.profiler`` (which
slows it), and the operations and CUDA runtime calls that took the most
host time in it, waits left out, are printed beside its capture's enqueue
ms (on standard error).

With ``--compare A B`` the script runs itself on tree A, B, B, A (a process
each, so that each imports its own ``tsim_tpu_torch`` and builds its own
kernels) and prints both trees' numbers side by side. A tree is a checkout of
this repository (``git archive <commit> | tar -x -C build/parent``); trees
from before ``models/exported.py`` load the same programs from ``models``.

Needs a CUDA device; imports only the port.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

SHOTS = (1024, 16384, 1 << 20)
BATCH = 1 << 20


def card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip()


def _exported_models():
    """The module whose ``distillation_d3``/``cultivation_d3`` load the
    committed programs: ``models.exported``, or ``models`` itself in a tree
    from before the port compiled circuits."""
    from tsim_tpu_torch import models
    from tsim_tpu_torch.models import exported

    return exported if hasattr(exported, "distillation_d3") else models


def spread(values) -> list:
    import numpy as np

    return [float(np.median(values)), min(values), max(values)]


def measure_calls(reps: int) -> dict:
    """{label: [median ms, least ms, greatest ms]}."""
    import numpy as np

    circuit = _exported_models().distillation_d3(p=0.05)
    results = {}
    for shots in SHOTS:
        sampler = circuit.compile_detector_sampler(seed=0, device="cuda")
        for _ in range(2):  # warm-up: the kernels' build and self-test, the allocators, the step's capture
            sampler.sample(shots)
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = sampler.sample(shots)
            walls.append((time.perf_counter() - t0) * 1e3)
            assert out.shape[0] == shots and out.dtype == np.bool_
        results[f"d3 f32 sample({shots}), one batch"] = spread(walls)
    return results


def measure_paths(reps: int) -> dict:
    """{path: [median shots/s, least, greatest]}."""
    import numpy as np
    import torch

    models = _exported_models()
    postselect = {
        "postselection_mask": np.ones(11, bool), "use_detector_reference_sample": True,
        "use_observable_reference_sample": True, "separate_observables": True,
    }
    paths = {
        "d3 f32": (models.distillation_d3(p=0.05), {}, 8 * BATCH, {"append_observables": True}),
        "1-check cultivation f32": (models.cultivation_d3(p=0.001, checks=1), {}, 4 * BATCH,
                                    {"append_observables": True}),
        "postselected cultivation f32": (models.cultivation_d3(p=0.001, checks=2), {}, 4 * BATCH, postselect),
        "exact cultivation": (models.cultivation_d3(p=0.001, checks=2), {"evaluation": "exact"}, 4 * BATCH, {}),
    }
    results = {}
    for label, (circuit, options, shots, kwargs) in paths.items():
        sampler = circuit.compile_detector_sampler(seed=0, device="cuda", **options)
        sampler.sample(2 * BATCH, batch_size=BATCH, **kwargs)  # warm-up, and the step's capture
        torch.cuda.synchronize()
        rates = []
        for _ in range(reps):
            t0 = time.perf_counter()
            sampler.sample(shots, batch_size=BATCH, **kwargs)
            torch.cuda.synchronize()
            rates.append(shots / (time.perf_counter() - t0))
        results[label] = spread(rates)
    return results


def measure_defaults(reps: int) -> dict:
    """{path, way: [median shots/s, least, greatest]}, ways "default" and
    "2^20", and {path, "default batch": [rows] * 3}."""
    import numpy as np
    import torch

    from tsim_tpu_torch import models as built

    exported = _exported_models()
    shots = 1 << 22
    postselect = {
        "postselection_mask": np.ones(11, bool), "use_detector_reference_sample": True,
        "use_observable_reference_sample": True, "separate_observables": True,
    }
    grown = built.cultivation_d3_grown(p=0.001, checks=2)
    paths = {
        "d3 f32": (exported.distillation_d3(p=0.05), {}, {"append_observables": True}),
        "1-check cultivation f32": (exported.cultivation_d3(p=0.001, checks=1), {}, {"append_observables": True}),
        "postselected cultivation f32": (exported.cultivation_d3(p=0.001, checks=2), {}, postselect),
        "exact cultivation": (exported.cultivation_d3(p=0.001, checks=2), {"evaluation": "exact"}, {}),
        "grown f32": (grown, {}, {}),
        "grown exact": (grown, {"evaluation": "exact"}, {}),
    }
    results = {}
    for label, (circuit, options, kwargs) in paths.items():
        sampler = circuit.compile_detector_sampler(seed=0, device="cuda", **options)
        sampler.sample(2 * BATCH, batch_size=BATCH, **kwargs)  # warm-up, and the step's capture
        torch.cuda.synchronize()
        rates = {"default": [], "2^20": []}
        for _ in range(reps):
            for way in ("default", "2^20"):
                t0 = time.perf_counter()
                sampler.sample(shots, batch_size=None if way == "default" else BATCH, **kwargs)
                torch.cuda.synchronize()
                rates[way].append(shots / (time.perf_counter() - t0))
        for way, values in rates.items():
            results[f"{label}, {way}"] = spread(values)
        results[f"{label}, default batch"] = [sampler._plan_batches(shots, None)[0]] * 3
        del sampler
    return results


def _time_capture_parts() -> dict:
    """Wrap the tree's ``_StepGraph`` (where it has one) so that each
    capture records the host ms of its enqueue (and the CPU ms the calling
    thread spent in it), of ``capture_end`` and of its first replay, into
    the returned dict's lists."""
    import torch

    from tsim_tpu_torch import sampler as port_sampler

    parts = {"capture enqueue ms": [], "capture enqueue thread CPU ms": [], "capture_end ms": [],
             "first replay ms": []}
    if not hasattr(port_sampler, "_StepGraph"):
        return parts
    graph_class, step_class = torch.cuda.CUDAGraph, port_sampler._StepGraph
    begin, end, replay = graph_class.capture_begin, graph_class.capture_end, step_class.replay
    clock = {}

    def timed_begin(self, *args, **kwargs):
        begin(self, *args, **kwargs)
        clock["begin"], clock["cpu"] = time.perf_counter(), time.thread_time()

    def timed_end(self, *args, **kwargs):
        t0 = time.perf_counter()
        parts["capture enqueue ms"].append((t0 - clock.pop("begin")) * 1e3)
        parts["capture enqueue thread CPU ms"].append((time.thread_time() - clock.pop("cpu")) * 1e3)
        end(self, *args, **kwargs)
        parts["capture_end ms"].append((time.perf_counter() - t0) * 1e3)

    def timed_replay(self):
        if getattr(self, "_replayed", False):
            return replay(self)
        self._replayed = True
        t0 = time.perf_counter()
        out = replay(self)
        parts["first replay ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    graph_class.capture_begin, graph_class.capture_end, step_class.replay = timed_begin, timed_end, timed_replay
    return parts


def measure_first(reps: int, profile: bool) -> dict:
    """{path, quantity: [median, least, greatest]} over ``reps`` fresh
    samplers' first calls (and their second calls' shots/s)."""
    import gc

    import numpy as np
    import torch

    from tsim_tpu_torch import models as built

    exported = _exported_models()
    shots = 4 * BATCH
    grown = built.cultivation_d3_grown(p=0.001, checks=2)
    paths = {
        "d3 f32": (exported.distillation_d3(p=0.05), {}),
        "1-check cultivation f32": (exported.cultivation_d3(p=0.001, checks=1), {}),
        "exact cultivation": (exported.cultivation_d3(p=0.001, checks=2), {"evaluation": "exact"}),
        "grown f32": (grown, {}),
    }
    parts = _time_capture_parts()
    in_gc, gc_start = [0.0], [0.0]

    def on_gc(phase, info):
        if phase == "start":
            gc_start[0] = time.perf_counter()
        else:
            in_gc[0] += time.perf_counter() - gc_start[0]

    def call(sampler) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sampler.sample(shots, batch_size=BATCH)
        torch.cuda.synchronize()
        return shots / (time.perf_counter() - t0)

    def profiled(on: bool):
        if not on:
            return contextlib.nullcontext()
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def show(prof, what: str) -> None:
        if prof is None:
            return
        waits = ("cudaEventSynchronize", "cudaDeviceSynchronize", "cudaStreamSynchronize")
        events = [e for e in prof.key_averages() if e.key not in waits]
        events.sort(key=lambda e: e.self_cpu_time_total, reverse=True)
        print(f"{what}: capture enqueue " + "/".join(f"{v:.1f}" for v in parts["capture enqueue ms"])
              + " ms; most host time: "
              + ", ".join(f"{e.key} {e.count}x {e.self_cpu_time_total / 1e3:.2f} ms" for e in events[:6]),
              file=sys.stderr, flush=True)

    gc.callbacks.append(on_gc)
    results = {}
    for label, (circuit, options) in paths.items():
        warm = circuit.compile_detector_sampler(seed=0, device="cuda", **options)
        warm.sample(BATCH, batch_size=BATCH)
        del warm
        rows = {k: [] for k in ("first call shots/s", "second call shots/s", "first call gc ms",
                                "first call new segments", "first call alloc retries", *parts,
                                "call after dropping the graph shots/s",
                                "capture enqueue ms after dropping the graph")}
        for rep in range(reps):
            sampler = circuit.compile_detector_sampler(seed=1 + rep, device="cuda", **options)
            for values in parts.values():
                values.clear()
            before = torch.cuda.memory_stats()
            in_gc[0] = 0.0
            with profiled(profile) as prof:
                rows["first call shots/s"].append(call(sampler))
            rows["first call gc ms"].append(in_gc[0] * 1e3)
            after = torch.cuda.memory_stats()
            rows["first call new segments"].append(
                after.get("segment.all.allocated", 0) - before.get("segment.all.allocated", 0))
            rows["first call alloc retries"].append(
                after.get("num_alloc_retries", 0) - before.get("num_alloc_retries", 0))
            for key, values in parts.items():
                rows[key].append(sum(values))
            show(prof, f"{label} sampler {rep}")
            rows["second call shots/s"].append(call(sampler))
            if hasattr(sampler, "_drop_graphs"):
                sampler._drop_graphs()
                for values in parts.values():
                    values.clear()
                with profiled(profile) as prof:
                    rows["call after dropping the graph shots/s"].append(call(sampler))
                rows["capture enqueue ms after dropping the graph"].append(sum(parts["capture enqueue ms"]))
                show(prof, f"{label} sampler {rep} after dropping its graph")
            del sampler
        for key, values in rows.items():
            results[f"{label}, {key}"] = spread(values or [0.0])
        torch.cuda.empty_cache()
    gc.callbacks.remove(on_gc)
    return results


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--compare", nargs=2, metavar=("PARENT", "CHANGE"))
    parser.add_argument("--reps", type=int, help="calls timed (default 30, or 3 with --paths)")
    parser.add_argument("--paths", action="store_true", help="time the sampling paths of chip_smoke.py")
    parser.add_argument("--defaults", action="store_true",
                        help="time default-batch calls of those paths and grown cultivation")
    parser.add_argument("--first", action="store_true",
                        help="time fresh samplers' first calls, with the capture's parts")
    parser.add_argument("--profile", action="store_true",
                        help="with --first: also list the CUDA runtime calls of a first call")
    parser.add_argument("--json", action="store_true", help="print one JSON object and nothing else")
    args = parser.parse_args()
    reps = args.reps or (3 if args.paths or args.defaults or args.first else 30)
    unit = "shots/s" if args.paths or args.defaults else "(see label)" if args.first else "ms"

    if args.compare:
        print(card(), flush=True)
        parent, change = (os.path.abspath(p) for p in args.compare)
        runs = []
        for tree in (parent, change, change, parent):
            cmd = [sys.executable, os.path.abspath(__file__), "--tree", tree, "--reps", str(reps), "--json"]
            cmd += ["--paths"] if args.paths else ["--defaults"] if args.defaults else ["--first"] if args.first else []
            done = subprocess.run(cmd, capture_output=True, text=True, cwd=tree)
            if done.returncode != 0:
                sys.exit(f"FAIL: {tree}: {done.stdout[-2000:]}{done.stderr[-4000:]}")
            runs.append(json.loads(done.stdout.strip().splitlines()[-1]))
        print(f"{'call':56s} {f'parent median (least-greatest) {unit}':>52s} "
              f"{f'change median (least-greatest) {unit}':>52s}")
        for label in runs[0]:
            cols = []
            for a, b in ((runs[0], runs[3]), (runs[1], runs[2])):
                cols.append(" / ".join(f"{r[label][0]:.3f} ({r[label][1]:.3f}-{r[label][2]:.3f})" for r in (a, b)))
            print(f"{label:56s} {cols[0]:>52s} {cols[1]:>52s}")
        print(json.dumps({"card": card(), "parent": [runs[0], runs[3]], "change": [runs[1], runs[2]]}))
        return

    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        sys.exit("FAIL: needs a CUDA device")
    if args.first:
        results = measure_first(reps, args.profile)
    else:
        results = (measure_paths if args.paths else measure_defaults if args.defaults else measure_calls)(reps)
    if not args.json:
        print(card())
        for label, (median, least, greatest) in results.items():
            print(f"{label:56s} {median:9.3f} ({least:.3f}-{greatest:.3f}) {unit}")
    print(json.dumps(results))


if __name__ == "__main__":
    main()
