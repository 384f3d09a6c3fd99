"""Shots/s of d3 distillation f32 sampling (tsim_tpu_torch) against the
number of cards of a shot mesh, on the cards of this machine.

    python3 dev/torch_shard_scaling.py [--calls 3] [--batches 8] [--out build/shard_scaling.json]
    python3 dev/torch_shard_scaling.py --threshold [--calls 3] [--batches 4]
    python3 dev/torch_shard_scaling.py --auto [--program d3|cultivation|grown] [--calls 3] [--batches 4]
    python3 dev/torch_shard_scaling.py --sweep [--calls 3]

For each mesh, ``distillation_d3(p=0.05).compile_detector_sampler(seed=0,
mesh=mesh)`` samples after a warm-up call of two batches (the second
captures each shard's batch step, which the timed calls replay), ``--calls`` times, with
observables appended, in two ways:

* ``fixed``: ``--batches`` batches of 2^20 shots, the batch split over the
  mesh (``chip_smoke.py`` phase 23's call);
* ``per_shard``: ``--batches`` batches of 2^20 shots a shard, so that each
  card keeps phase 4's rows a launch.

The meshes: unsharded on card 0 (``mesh=None``), two replicas of card 0,
and cards 0 .. k - 1 for every k from 2 to the number of cards. Prints one
JSON line per mesh and way (median and best shots/s over the calls, wall
seconds of each call) after the cards' names and power limits, and writes
them all to ``--out``.

``--threshold`` measures what ``sampler.AUTO_MIN_ROWS_PER_CARD`` rests on:
for 2^17 to 2^21 rows a card and k = 2 and 4 cards (those there are), a
batch of k times those rows split over cards 0 .. k - 1 against the same
batch on card 0 alone, in turns (one card, k cards, k cards, one card);
one JSON line each with both medians and their ratio.

``--auto`` measures the rule itself: for batches of 2^18 to 2^21 rows and
the default batch (no ``batch_size``, 2^22 shots a call), the sampler on
card 0 alone, on an explicit mesh of every card and under ``mesh="auto"``;
each line holds the batch and the shards and cards that the package's own
planning (``sampler._plan_batches``) took for it. ``--program cultivation``
samples 2-check cultivation in exact mode, ``--program grown``
``models.cultivation_d3_grown(p=0.001, checks=2)`` in f32 mode (compiled
once on this host, about a minute), programs whose batches are bound by the
cards' work rather than by the host.

``--sweep`` measures what ``sampler.DEFAULT_ROWS_PER_CARD`` rests on: on
card 0 alone, d3 f32, 2-check cultivation exact and grown cultivation f32 at
batches of 2^17 to 2^22 rows and at the default batch, 2^24 shots a call at
each (so that every call is as long, four batches at the largest). Needs a CUDA device and the committed
programs.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BATCH = 1 << 20


def meshes(n_cards: int) -> list[tuple[str, object]]:
    from tsim_tpu_torch.parallel.shard import ShotMesh

    out = [("unsharded cuda:0", None), ("2 replicas of cuda:0", ShotMesh(["cuda:0"] * 2))]
    out += [(f"{k} cards", ShotMesh([f"cuda:{i}" for i in range(k)])) for k in range(2, n_cards + 1)]
    return out


def sampler_for(program: str, **kw):
    if program == "cultivation":
        from tsim_tpu_torch.models.exported import cultivation_d3

        return cultivation_d3(p=0.001, checks=2).compile_detector_sampler(seed=0, evaluation="exact", **kw)
    if program == "grown":
        from tsim_tpu_torch.models import cultivation_d3_grown

        # The in-process compile cache makes every sampler after the first cheap.
        return cultivation_d3_grown(p=0.001, checks=2).compile_detector_sampler(seed=0, **kw)
    from tsim_tpu_torch.models.exported import distillation_d3

    return distillation_d3(p=0.05).compile_detector_sampler(seed=0, **kw)


def run(label: str, mesh, way: str, calls: int, batches: int, base: int | None = BATCH,
        program: str = "d3", default_shots: int = 1 << 22) -> dict:
    """``batches`` batches of ``base`` shots (a shard's with ``per_shard``);
    ``base`` None: ``default_shots`` at the default batch. The line's
    ``batch``, ``shards`` and ``cards`` are the package's plan for the call."""
    import torch

    shards = 1 if mesh is None or mesh == "auto" else mesh.size
    batch = None if base is None else base * (shards if way == "per_shard" else 1)
    shots = default_shots if batch is None else batches * batch
    kw = {"device": "cuda:0", "mesh": None} if mesh is None else {"mesh": mesh}
    sampler = sampler_for(program, **kw)
    size, taken = sampler._plan_batches(shots, batch)
    shards = len(taken)
    devices = [torch.device(f"cuda:{i}") for i in range(torch.cuda.device_count())]
    # Warm-up: the kernels, then each shard's batch step captured for the size.
    sampler.sample(2 * size, batch_size=size, append_observables=True)
    walls = []
    for _ in range(calls):
        for d in devices:
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        out = sampler.sample(shots, batch_size=batch, append_observables=True)
        for d in devices:
            torch.cuda.synchronize(d)
        walls.append(time.perf_counter() - t0)
        del out
    rates = sorted(shots / w for w in walls)
    return {
        "program": program, "mesh": label, "way": way, "shards": shards,
        "cards": len({s.device for s in taken}), "batch": size, "batch_given": batch,
        "shots": shots, "median_shots_per_s": statistics.median(rates), "best_shots_per_s": rates[-1],
        "walls_s": walls, "norm_deviation": sampler.last_norm_deviation,
    }


def threshold(n_cards: int, calls: int, batches: int) -> list[dict]:
    """Sharded against unsharded at equal batches, per rows a card."""
    from tsim_tpu_torch.parallel.shard import ShotMesh

    out = []
    for k in (c for c in (2, 4) if c <= n_cards):
        mesh = ShotMesh([f"cuda:{i}" for i in range(k)])
        for log2 in range(17, 22):
            rows = 1 << log2
            batch = k * rows
            one = [run("unsharded cuda:0", None, "fixed", calls, batches, batch)]
            many = [run(f"{k} cards", mesh, "fixed", calls, batches, batch)]
            many.append(run(f"{k} cards", mesh, "fixed", calls, batches, batch))
            one.append(run("unsharded cuda:0", None, "fixed", calls, batches, batch))
            a = statistics.median(r["median_shots_per_s"] for r in one)
            b = statistics.median(r["median_shots_per_s"] for r in many)
            row = {"cards": k, "rows_a_card": rows, "batch": batch, "one_card_shots_per_s": a,
                   "sharded_shots_per_s": b, "sharded_over_one": b / a}
            out.append(row)
            print(json.dumps(row), flush=True)
    return out


def auto(n_cards: int, calls: int, batches: int, program: str) -> list[dict]:
    """One card, every card and "auto" at each batch size."""
    from tsim_tpu_torch.parallel.shard import ShotMesh

    every = ShotMesh([f"cuda:{i}" for i in range(n_cards)])
    out = []
    for batch in (1 << 18, 1 << 19, 1 << 20, 1 << 21, None):
        for label, mesh in (("unsharded cuda:0", None), (f"{n_cards} cards", every), ("auto", "auto")):
            row = run(label, mesh, "fixed", calls, batches, batch, program)
            out.append(row)
            print(json.dumps(row), flush=True)
    return out


SWEEP_SHOTS = 1 << 24


def sweep(calls: int) -> list[dict]:
    """One card's shots/s against its batch, by program, SWEEP_SHOTS a call."""
    out = []
    for program in ("d3", "cultivation", "grown"):
        for batch in [1 << k for k in range(17, 23)] + [None]:
            row = run("unsharded cuda:0", None, "fixed", calls, SWEEP_SHOTS // (batch or 1), batch, program,
                      SWEEP_SHOTS)
            out.append(row)
            print(json.dumps(row), flush=True)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--calls", type=int, default=3)
    parser.add_argument("--batches", type=int, default=8)
    parser.add_argument("--out", default="build/shard_scaling.json")
    parser.add_argument("--threshold", action="store_true")
    parser.add_argument("--auto", action="store_true")
    parser.add_argument("--sweep", action="store_true")
    parser.add_argument("--program", choices=("d3", "cultivation", "grown"), default="d3", help="with --auto")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    from tsim_tpu_torch.kernels import build

    build.build()
    build.load()
    if args.threshold or args.auto or args.sweep:
        if args.threshold:
            rows = threshold(torch.cuda.device_count(), args.calls, args.batches)
        elif args.auto:
            rows = auto(torch.cuda.device_count(), args.calls, args.batches, args.program)
        else:
            rows = sweep(args.calls)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        key = "threshold" if args.threshold else "auto" if args.auto else "sweep"
        Path(args.out).write_text(json.dumps({"cards": smi.stdout.strip().splitlines(), key: rows}, indent=1))
        return
    rows = []
    for label, mesh in meshes(torch.cuda.device_count()):
        for way in ("fixed", "per_shard"):
            row = run(label, mesh, way, args.calls, args.batches)
            rows.append(row)
            print(json.dumps(row), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"cards": smi.stdout.strip().splitlines(), "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
