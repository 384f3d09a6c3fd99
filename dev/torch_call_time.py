"""Time ``sample()`` calls of the port's samplers on a CUDA card
(tsim_tpu_torch), for one tree or for two in turns.

    python3 dev/torch_call_time.py [--tree .] [--reps 30] [--paths]
    python3 dev/torch_call_time.py --compare build/parent . [--paths | --defaults]

By default, one-batch calls of d3 distillation's f32 detector sampler: for
1024, 16,384 and 2^20 shots, one sampler makes a warm-up call and then
``--reps`` calls of ``sampler.sample(shots)`` with the default batch size,
which is one batch at these counts; each call is timed on the host's clock
(it returns a host array, so it ends synchronised). Printed: the median,
least and greatest wall time in ms.

With ``--paths``, the sampling paths of ``chip_smoke.py``'s phases 4, 7, 10
and 12, each from its committed program as those phases sample it: d3
distillation f32 (8 * 2^20 shots with observables), 1-check cultivation f32
(4 * 2^20), postselected 2-check cultivation f32 (4 * 2^20, every detector
postselected, both reference samples) and 2-check cultivation in exact mode
(4 * 2^20), all at ``batch_size=2**20``. One sampler a path makes one
warm-up batch, then ``--reps`` calls (default 3), each timed on the host's
clock to a ``torch.cuda.synchronize()``. Printed: the median, least and
greatest shots/s.

With ``--defaults``, the same paths and noisy grown cultivation
(``models.cultivation_d3_grown(p=0.001, checks=2)``, compiled on this host;
f32 and exact) with no ``batch_size``, as a user calls ``sample()``, and at
``batch_size=2**20``, in turns, 2^22 shots a call: the default batch's rate
beside the explicit one's, and the default batch the tree chose
(``_plan_batches``; of the plain path, also for the postselected one). Set
``TSIM_TPU_COMPILE_CACHE_DIR`` to compile grown cultivation once a tree.

With ``--compare A B`` the script runs itself on tree A, B, B, A (a process
each, so that each imports its own ``tsim_tpu_torch`` and builds its own
kernels) and prints both trees' numbers side by side. A tree is a checkout of
this repository (``git archive <commit> | tar -x -C build/parent``); trees
from before ``models/exported.py`` load the same programs from ``models``.

Needs a CUDA device; imports only the port.
"""

from __future__ import annotations

import argparse
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
        sampler.sample(shots)  # warm-up: the kernels' build and self-test, the allocators
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
        sampler.sample(BATCH, batch_size=BATCH, **kwargs)  # warm-up
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
        sampler.sample(BATCH, batch_size=BATCH, **kwargs)  # warm-up
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


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--compare", nargs=2, metavar=("PARENT", "CHANGE"))
    parser.add_argument("--reps", type=int, help="calls timed (default 30, or 3 with --paths)")
    parser.add_argument("--paths", action="store_true", help="time the sampling paths of chip_smoke.py")
    parser.add_argument("--defaults", action="store_true",
                        help="time default-batch calls of those paths and grown cultivation")
    parser.add_argument("--json", action="store_true", help="print one JSON object and nothing else")
    args = parser.parse_args()
    reps = args.reps or (3 if args.paths or args.defaults else 30)
    unit = "shots/s" if args.paths or args.defaults else "ms"

    if args.compare:
        print(card(), flush=True)
        parent, change = (os.path.abspath(p) for p in args.compare)
        runs = []
        for tree in (parent, change, change, parent):
            cmd = [sys.executable, os.path.abspath(__file__), "--tree", tree, "--reps", str(reps), "--json"]
            cmd += ["--paths"] if args.paths else ["--defaults"] if args.defaults else []
            done = subprocess.run(cmd, capture_output=True, text=True, cwd=tree)
            if done.returncode != 0:
                sys.exit(f"FAIL: {tree}: {done.stdout[-2000:]}{done.stderr[-4000:]}")
            runs.append(json.loads(done.stdout.strip().splitlines()[-1]))
        print(f"{'call':40s} {f'parent median (least-greatest) {unit}':>52s} "
              f"{f'change median (least-greatest) {unit}':>52s}")
        for label in runs[0]:
            cols = []
            for a, b in ((runs[0], runs[3]), (runs[1], runs[2])):
                cols.append(" / ".join(f"{r[label][0]:.3f} ({r[label][1]:.3f}-{r[label][2]:.3f})" for r in (a, b)))
            print(f"{label:40s} {cols[0]:>52s} {cols[1]:>52s}")
        print(json.dumps({"card": card(), "parent": [runs[0], runs[3]], "change": [runs[1], runs[2]]}))
        return

    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        sys.exit("FAIL: needs a CUDA device")
    results = (measure_paths if args.paths else measure_defaults if args.defaults else measure_calls)(reps)
    if not args.json:
        print(card())
        for label, (median, least, greatest) in results.items():
            print(f"{label:40s} {median:9.3f} ({least:.3f}-{greatest:.3f}) {unit}")
    print(json.dumps(results))


if __name__ == "__main__":
    main()
