"""Time the small kernels (K2, K7a, K7b), the wide f32 kernel's two instances
(K1) with the self-test's probe (K4), and the wide exact kernels (K5, K6) rung
by rung on a CUDA card, for one tree or for two trees in turns.

    python3 dev/torch_time_rungs.py [--tree .] [--reps 20]
    python3 dev/torch_time_rungs.py --compare build/parent .

With ``--compare A B`` the script runs itself on tree A, B, B, A (a process
each, so that each imports its own ``tsim_tpu_torch`` and builds its own
kernels) and prints both trees' means side by side: a change is compared with
its parent inside one call, on one card. A tree is a checkout of this
repository (``git archive <commit> | tar -x -C build/parent``).

Timed with CUDA events after a warm-up: the wide exact kernels around
``--reps`` launches; the others, whose launches may be shorter than the host
takes to enqueue one, each launch between its own pair of events, all queued
behind a sleep on the card, so that the host's time stays outside the pairs
(device time):

* ``small`` (``kernels.sample_eval.launch``) on every rung under 24 graphs of
  d3 distillation, 1-check and 2-check cultivation at 2^20 + 1 seeded rows,
  and on d3's 6-graph rung and 1-check's last 16-graph rung at 1024 and
  16,384 rows;
* ``approx_wide`` (``kernels.exact_eval.approx_partials``) on the joint rung
  of d3's state probabilities, on seeded rows and on the rows the path itself
  evaluates (f-bits drawn by ``CompiledStateProbs``' noise sampler, the first
  exported state tiled behind them), and on d3's three wide rungs;
* ``approx_small`` on d3's two small approximate rungs at 2^20 + 1, 1024 and
  16,384 rows (device time),
  ``exact_wide`` on 2-check cultivation's 307-graph rung, ``exact_small``
  (device time) on its 4-graph rung at 2^20 + 1, 1024 and 16,384 rows and on
  the state-probability norm rung;
* ``wide`` (``kernels.sample_eval.launch``, device time) on 2-check
  cultivation's 307-graph and d3's first 103-graph rung at 128 to 65,536 and
  2^20 + 1 rows, as the tree dispatches it and, where the tree has the
  private ``_block_shots``, each instance forced;
* the self-test probe's four launches (K4), summed and one by one;
* the per-term kernels: ``per_term_wide`` (K3a) on 2-check cultivation's
  307-graph rung and d3's first 103-graph rung at 2^20 + 1, 4097 and 128
  rows (the last two take its 32-shot block where the tree has one),
  ``per_term_small`` (K3b) on d3's 6-graph rung and 1-check's last 16-graph
  rung at 2^20 + 1 and 4096 rows (device time);
* d3 sampling, ``sample(4 * B, batch_size=B)`` after a warm-up batch, with
  ``per_term=True`` (every rung on K3a/K3b) and ``per_term=False``, at B =
  4096, 65,536 and 2^20: shots/s on the host's clock (a ratio above 1 in the
  last column is then the parent's gain).

A label that only one tree times is printed with the other's column empty.

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
SWEEP_ROWS = (128, 1024, 4096, 8192, 16384, 32768, 65536)


def seeded_rows(n_params: int, count: int, seed: int):
    import torch

    x = np.random.default_rng(seed).integers(0, 2, size=(count, n_params), dtype=np.uint8)
    return torch.from_numpy(x).to("cuda")


def measure(reps: int) -> dict:
    """{label: ms} of every timed launch, on the tree first on sys.path."""
    import inspect

    from tsim_tpu_torch.compile import sample_eval as f32_eval
    from tsim_tpu_torch.compile.exact_tables import ExactTables
    from tsim_tpu_torch.compile.sample_tables import SampleTables
    from tsim_tpu_torch.kernels import exact_eval, sample_eval
    from tsim_tpu_torch.models.exported import cultivation_d3, distillation_d3

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
        config = exact_eval.configuration(t.num_graphs)
        kind = f"{'approx' if t.approximate else 'exact'}_{config}"
        timer = time_ms if config == "wide" else device_ms
        out[f"{kind} {label} G={t.num_graphs} P={t.n_params} B={x.shape[0]}"] = timer(lambda: fn(t, x), reps)

    forced = "_block_shots" in inspect.signature(sample_eval.launch).parameters
    for name, i in (("cultivation", 9), ("d3", 3)):
        c = rungs[name][i]
        t = SampleTables(c).to("cuda")
        x = seeded_rows(c.n_params, ROWS, seed=80 + i)
        for rows in (*SWEEP_ROWS, ROWS):
            xs = x[:rows]
            label = f"wide {name}[{i}] G={c.num_graphs} B={rows}"
            out[label] = device_ms(lambda: sample_eval.launch(t, xs, "wide"), reps)
            for shots in (32, 128) if forced else ():
                out[f"{label} shots={shots}"] = device_ms(
                    lambda: sample_eval.launch(t, xs, "wide", _block_shots=shots), reps)
    probe, x = f32_eval.probe_inputs("cuda")
    each = {c: device_ms(lambda: sample_eval.launch(probe[c.removeprefix("per_term_")], x, c), reps)
            for c in sample_eval.CONFIGURATIONS}
    out["self-test probe, 4 launches summed"] = sum(each.values())
    for c, ms in each.items():
        out[f"self-test probe {c}"] = ms

    for name, i, config, batches in (
        ("cultivation", 9, "per_term_wide", (ROWS, 4097, 128)),
        ("d3", 3, "per_term_wide", (ROWS, 4097, 128)),
        ("d3", 2, "per_term_small", (ROWS, 4096)),
        ("cultivation_checks1", 7, "per_term_small", (ROWS, 4096)),
    ):
        c = rungs[name][i]
        t = SampleTables(c).to("cuda")
        x = seeded_rows(c.n_params, ROWS, seed=100 + i)
        for rows in batches:
            xs = x[:rows]
            out[f"{config} {name}[{i}] G={c.num_graphs} B={rows}"] = device_ms(
                lambda: sample_eval.launch(t, xs, config), reps)

    import time

    import torch

    for per_term in (False, True):
        for batch in (4096, 1 << 16, 1 << 20):
            sampler = d3.compile_detector_sampler(seed=0, device="cuda", per_term=per_term)
            sampler.sample(batch, batch_size=batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sampler.sample(4 * batch, batch_size=batch)
            torch.cuda.synchronize()
            out[f"d3 sampling per_term={per_term} B={batch}: shots/s"] = 4 * batch / (time.perf_counter() - t0)

    joint = d3.load_state_probs().program.components[0].compiled_scalar_graphs[1]
    exact("state probs, seeded rows", ExactTables(joint).to("cuda"), seeded_rows(joint.n_params, ROWS, seed=50))
    joint_tables, path_rows = state_prob_path_rows(d3, ROWS)
    out["state probs, path rows: share of ones"] = float(path_rows.float().mean())
    exact("state probs, path rows", joint_tables, path_rows)
    for i in (1, 2, 3, 4, 5):
        c = rungs["d3"][i]
        t, x = ExactTables(c).to("cuda"), seeded_rows(c.n_params, ROWS, seed=60 + i)
        for rows in (ROWS, *SMALL_BATCHES) if i in (1, 2) else (ROWS,):
            exact(f"d3[{i}]", t, x[:rows])
    for i in (9, 1):
        c = rungs["cultivation"][i]
        t, x = ExactTables(c).to("cuda"), seeded_rows(c.n_params, ROWS, seed=70 + i)
        for rows in (ROWS, *SMALL_BATCHES) if i == 1 else (ROWS,):
            exact(f"cultivation[{i}]", t, x[:rows])
    norm = d3.load_state_probs().program.components[0].compiled_scalar_graphs[0]
    exact("state probs, norm rung", ExactTables(norm).to("cuda"), seeded_rows(norm.n_params, ROWS, seed=90))
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
        labels = list(runs[0]) + [k for k in runs[1] if k not in runs[0]]
        for label in labels:
            a, b = (runs[0].get(label), runs[3].get(label)), (runs[1].get(label), runs[2].get(label))
            cols = [f"{v[0]:9.4f} / {v[1]:8.4f}" if None not in v else f"{'':20s}" for v in (a, b)]
            ratio = f"{(a[0] + a[1]) / (b[0] + b[1]):6.2f}" if None not in a + b else ""
            print(f"{label:70s} {cols[0]} {cols[1]}  {ratio}")
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
