"""Time the small f32 kernel (K2) and the approximate exact kernels (K6, K7b)
rung by rung on a CUDA card, for one tree or for two trees in turns.

    python3 dev/torch_time_rungs.py [--tree .] [--reps 20]
    python3 dev/torch_time_rungs.py --compare build/parent .

With ``--compare A B`` the script runs itself on tree A, B, B, A (a process
each, so that each imports its own ``tsim_tpu_torch`` and builds its own
kernels) and prints both trees' means side by side: a change is compared with
its parent inside one call, on one card. A tree is a checkout of this
repository (``git archive <commit> | tar -x -C build/parent``).

Timed with CUDA events after a warm-up: the exact kernels around ``--reps``
launches; the small f32 kernel, whose launches are shorter than the host takes
to enqueue one, each launch between its own pair of events, all queued behind a
sleep on the card, so that the host's time stays outside the pairs:

* ``small`` (``kernels.sample_eval.launch``) on every rung under 24 graphs of
  d3 distillation, 1-check and 2-check cultivation at 2^20 + 1 seeded rows,
  and on d3's 6-graph rung and 1-check's last 16-graph rung at 1024 and
  16,384 rows;
* ``approx_wide`` (``kernels.exact_eval.approx_partials``) on the joint rung
  of d3's state probabilities, on seeded rows and on the rows the path itself
  evaluates (f-bits drawn by ``CompiledStateProbs``' noise sampler, the first
  exported state tiled behind them), and on d3's three wide rungs;
* ``approx_small`` on d3's two small approximate rungs, and ``exact_wide`` and
  ``exact_small`` on 2-check cultivation's 307- and 4-graph rungs (these two
  share code with the approximate kernels and must not move).

Needs a CUDA device; imports only the port.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
from torch_kernel_ablate import device_ms, state_prob_path_rows, time_ms  # beside this script

ROWS = (1 << 20) + 1
SMALL_BATCHES = (1024, 16384)


def seeded_rows(n_params: int, count: int, seed: int):
    import torch

    x = np.random.default_rng(seed).integers(0, 2, size=(count, n_params), dtype=np.uint8)
    return torch.from_numpy(x).to("cuda")


def measure(reps: int) -> dict:
    """{label: ms} of every timed launch, on the tree first on sys.path."""
    from tsim_tpu_torch.compile.exact_tables import ExactTables
    from tsim_tpu_torch.compile.sample_tables import SampleTables
    from tsim_tpu_torch.kernels import exact_eval, sample_eval
    from tsim_tpu_torch.models import cultivation_d3, distillation_d3

    d3 = distillation_d3(p=0.05)
    programs = {
        "d3": d3.load(),
        "cultivation_checks1": cultivation_d3(p=0.001, checks=1).load(),
        "cultivation": cultivation_d3(p=0.001, checks=2).load(),
    }
    rungs = {name: e.program.components[0].compiled_scalar_graphs for name, e in programs.items()}
    out = {}

    for name, ladder in rungs.items():
        for i, c in enumerate(ladder):
            if sample_eval.layout(c.num_graphs) != "small":
                continue
            t = SampleTables(c).to("cuda")
            batches = (ROWS,)
            if (name, i) in (("d3", 2), ("cultivation_checks1", 7)):
                batches += SMALL_BATCHES
            for rows in batches:
                x = seeded_rows(c.n_params, rows, seed=i)
                ms = device_ms(lambda: sample_eval.launch(t, x, "small"), reps)
                out[f"small {name}[{i}] G={c.num_graphs} P={c.n_params} B={rows}"] = ms

    def exact(label, t, x):
        fn = exact_eval.approx_partials if t.approximate else exact_eval.exact_partials
        kind = f"{'approx' if t.approximate else 'exact'}_{exact_eval.configuration(t.num_graphs)}"
        out[f"{kind} {label} G={t.num_graphs} P={t.n_params} B={x.shape[0]}"] = time_ms(lambda: fn(t, x), reps)

    joint = d3.load_state_probs().program.components[0].compiled_scalar_graphs[1]
    exact("state probs, seeded rows", ExactTables(joint).to("cuda"), seeded_rows(joint.n_params, ROWS, seed=50))
    joint_tables, path_rows = state_prob_path_rows(d3, ROWS)
    out["state probs, path rows: share of ones"] = float(path_rows.float().mean())
    exact("state probs, path rows", joint_tables, path_rows)
    for i in (1, 2, 3, 4, 5):
        c = rungs["d3"][i]
        exact(f"d3[{i}]", ExactTables(c).to("cuda"), seeded_rows(c.n_params, ROWS, seed=60 + i))
    for i in (9, 1):
        c = rungs["cultivation"][i]
        exact(f"cultivation[{i}]", ExactTables(c).to("cuda"), seeded_rows(c.n_params, ROWS, seed=70 + i))
    return out


def card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return smi.stdout.strip().splitlines()[0]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--compare", nargs=2, metavar=("PARENT", "CHANGE"))
    parser.add_argument("--reps", type=int, default=20)
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
        print(f"{'launch':70s} {'parent ms':>20s} {'change ms':>20s}  parent / change")
        for label in runs[0]:
            a, b = (runs[0][label], runs[3][label]), (runs[1].get(label), runs[2].get(label))
            if None in b:
                continue
            ratio = (a[0] + a[1]) / (b[0] + b[1])
            print(f"{label:70s} {a[0]:9.4f} / {a[1]:8.4f} {b[0]:9.4f} / {b[1]:8.4f}  {ratio:6.2f}")
        print(json.dumps({"card": card(), "parent": [runs[0], runs[3]], "change": [runs[1], runs[2]]}))
        return

    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        sys.exit("FAIL: needs a CUDA device")
    results = measure(args.reps)
    if not args.json:
        print(card())
        for label, ms in results.items():
            print(f"{label:70s} {ms:9.4f}")
    print(json.dumps(results))


if __name__ == "__main__":
    main()
