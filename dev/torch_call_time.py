"""Time one-batch ``sample()`` calls of d3 distillation's f32 detector
sampler on a CUDA card (tsim_tpu_torch), for one tree or for two in turns.

    python3 dev/torch_call_time.py [--tree .] [--reps 30]
    python3 dev/torch_call_time.py --compare build/parent .

For 1024, 16,384 and 2^20 shots, one sampler makes a warm-up call and then
``--reps`` calls of ``sampler.sample(shots)`` with the default batch size,
which is one batch at these counts; each call is timed on the host's clock
(it returns a host array, so it ends synchronised). Printed: the median,
least and greatest wall time in ms.

With ``--compare A B`` the script runs itself on tree A, B, B, A (a process
each, so that each imports its own ``tsim_tpu_torch`` and builds its own
kernels) and prints both trees' medians side by side. A tree is a checkout of
this repository (``git archive <commit> | tar -x -C build/parent``).

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


def card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip()


def measure(reps: int) -> dict:
    """{label: [median ms, least ms, greatest ms]}."""
    import numpy as np

    from tsim_tpu_torch.models import distillation_d3

    circuit = distillation_d3(p=0.05)
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
        results[f"d3 f32 sample({shots}), one batch"] = [float(np.median(walls)), min(walls), max(walls)]
    return results


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--compare", nargs=2, metavar=("PARENT", "CHANGE"))
    parser.add_argument("--reps", type=int, default=30)
    parser.add_argument("--json", action="store_true", help="print one JSON object and nothing else")
    args = parser.parse_args()

    if args.compare:
        print(card(), flush=True)
        parent, change = (os.path.abspath(p) for p in args.compare)
        runs = []
        for tree in (parent, change, change, parent):
            cmd = [sys.executable, os.path.abspath(__file__), "--tree", tree, "--reps", str(args.reps), "--json"]
            done = subprocess.run(cmd, capture_output=True, text=True, cwd=tree)
            if done.returncode != 0:
                sys.exit(f"FAIL: {tree}: {done.stdout[-2000:]}{done.stderr[-4000:]}")
            runs.append(json.loads(done.stdout.strip().splitlines()[-1]))
        print(f"{'call':40s} {'parent median (least-greatest) ms':>44s} {'change median (least-greatest) ms':>44s}")
        for label in runs[0]:
            cols = []
            for a, b in ((runs[0], runs[3]), (runs[1], runs[2])):
                cols.append(" / ".join(f"{r[label][0]:.3f} ({r[label][1]:.3f}-{r[label][2]:.3f})" for r in (a, b)))
            print(f"{label:40s} {cols[0]:>44s} {cols[1]:>44s}")
        print(json.dumps({"card": card(), "parent": [runs[0], runs[3]], "change": [runs[1], runs[2]]}))
        return

    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        sys.exit("FAIL: needs a CUDA device")
    results = measure(args.reps)
    if not args.json:
        print(card())
        for label, (median, least, greatest) in results.items():
            print(f"{label:40s} {median:9.3f} ({least:.3f}-{greatest:.3f}) ms")
    print(json.dumps(results))


if __name__ == "__main__":
    main()
