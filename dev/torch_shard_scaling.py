"""Shots/s of d3 distillation f32 sampling (tsim_tpu_torch) against the
number of cards of a shot mesh, on the cards of this machine.

    python3 dev/torch_shard_scaling.py [--calls 3] [--batches 8] [--out build/shard_scaling.json]

For each mesh, ``distillation_d3(p=0.05).compile_detector_sampler(seed=0,
mesh=mesh)`` samples after one warm-up call, ``--calls`` times, with
observables appended, in two ways:

* ``fixed``: ``--batches`` batches of 2^20 shots, the batch split over the
  mesh (``chip_smoke.py`` phase 23's call);
* ``per_shard``: ``--batches`` batches of 2^20 shots a shard, so that each
  card keeps phase 4's rows a launch.

The meshes: unsharded on card 0 (``mesh=None``), two replicas of card 0,
and cards 0 .. k - 1 for every k from 2 to the number of cards. Prints one
JSON line per mesh and way (median and best shots/s over the calls, wall
seconds of each call) after the cards' names and power limits, and writes
them all to ``--out``. Needs a CUDA device and the committed programs.
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


def run(label: str, mesh, way: str, calls: int, batches: int) -> dict:
    import torch

    from tsim_tpu_torch.models.exported import distillation_d3

    shards = 1 if mesh is None else mesh.size
    batch = BATCH * (shards if way == "per_shard" else 1)
    shots = batches * batch
    kw = {"device": "cuda:0", "mesh": None} if mesh is None else {"mesh": mesh}
    sampler = distillation_d3(p=0.05).compile_detector_sampler(seed=0, **kw)
    devices = [torch.device("cuda:0")] if mesh is None else list(mesh.distinct)
    sampler.sample(batch, batch_size=batch, append_observables=True)  # warm-up
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
        "mesh": label, "way": way, "shards": shards, "cards": len(devices), "batch": batch,
        "shots": shots, "median_shots_per_s": statistics.median(rates), "best_shots_per_s": rates[-1],
        "walls_s": walls, "norm_deviation": sampler.last_norm_deviation,
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--calls", type=int, default=3)
    parser.add_argument("--batches", type=int, default=8)
    parser.add_argument("--out", default="build/shard_scaling.json")
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
