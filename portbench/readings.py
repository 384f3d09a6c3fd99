"""The readings that the limits of ``judge.py`` are set from (PERF.md).

    python3 portbench/readings.py --workload <cell> [--seeds 12] [--control-seeds 3] [--seconds 51]

For each of ``--seeds`` seeds, a sampler of the cell is built in this one
process (the compile is cached), warmed up as a run warms it, and called
for ``--seconds``, as long as a run's window, and at least until the
judged calls of a run (``judge.kept_calls`` from the seed's offset) have
come back. Those rows are judged as a run judges them, and the sampler's
normalization monitor is read after every call. Then the control, for each of
``--control-seeds`` seeds: in a cell whose traffic asks for exact
evaluation, the program's own float32 path (the cell's sampler built with
``evaluation="f32"``), read the same way; in the others, the reference put
in the program's place, its distribution computed with every intermediate
rounded to bfloat16 (the precision below the float32 that the f32
evaluation states), and as many rows as a run judges drawn from it,
seeded. The benchmark's own runs never run this. Prints one JSON line a
reading and a summary line: for each number, the largest of the program's
readings (lower) and the smallest of the control's (upper).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path = [p for p in sys.path if Path(p or ".").resolve() != ROOT / "portbench"]
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from portbench import cells, judge, run  # noqa: E402
from portbench.reference.density import bf16_rounding, output_distribution  # noqa: E402

NUMBERS = ("max_abs_z", "repeated_chunks", "norm_off_share")


def program_reading(cell: cells.Cell, seed: int, device=None, evaluation: str | None = None,
                    seconds: float = 0.0) -> dict:
    """One seed's readings of the program (``evaluation`` in place of the
    traffic's where given)."""
    import torch

    from tsim_tpu_torch.circuit import Circuit

    traffic = cell.traffic
    evaluation = evaluation or traffic.evaluation
    sampler = Circuit(cell.config.circuit_text).compile_detector_sampler(
        seed=seed, device=device, evaluation=evaluation, mesh=traffic.mesh)
    call = run.make_call(sampler, traffic)
    run.warm_up(sampler, call, traffic.postselection is not None)
    keep, first = judge.kept_calls(traffic.shots), judge.first_kept(seed)
    kept, deviations = [], []
    started = time.perf_counter()
    while len(deviations) < first + keep or time.perf_counter() - started < seconds:
        out = call()
        deviations.append(sampler.last_norm_deviation)
        if first <= len(deviations) - 1 < first + keep:
            kept.append(out)
        del out
    del call, sampler
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    checks = run.judge_rows(cell, kept, judge.off_share(deviations))
    finite = [float(d or 0.0) for d in deviations]
    return {"seed": seed, "evaluation": evaluation, **{k: v["value"] for k, v in checks.items()},
            "norm_deviation_max": max(finite), "calls": len(deviations),
            "event": checks["max_abs_z"]["event"], "rows": sum(len(k) for k in kept)}


def reference_control_readings(cell: cells.Cell, seeds: list[int]) -> list[dict]:
    """The bfloat16 reference in the program's place, at the rows a run judges."""
    traffic = cell.traffic
    nd = cell.config.num_detectors
    columns = nd + (cell.config.num_observables if traffic.append_observables else 0)
    q_ref, _ = output_distribution(cell.config.circuit_text)
    q_ctl, _ = output_distribution(cell.config.circuit_text, rounding=bf16_rounding)
    q_ref = judge.marginal(q_ref, nd, traffic.append_observables)
    q_ctl = np.clip(judge.marginal(q_ctl, nd, traffic.append_observables), 0.0, None)
    q_ctl = q_ctl / q_ctl.sum()
    rows = judge.kept_calls(traffic.shots) * traffic.shots
    out = []
    for seed in seeds:
        hist = np.random.default_rng(seed).multinomial(rows, q_ctl)
        checks = judge.checks_of(hist, q_ref, columns, nd, traffic.postselection is not None, 0)
        out.append({"seed": seed, "control": "bfloat16 reference", "max_abs_z": checks["max_abs_z"]["value"],
                    "event": checks["max_abs_z"]["event"], "rows": rows})
    return out


def control_readings(cell: cells.Cell, seeds: list[int], seconds: float = 0.0, device=None) -> list[dict]:
    """The control of the cell's check: the program's float32 path where the
    traffic asks for exact evaluation, else the bfloat16 reference."""
    if cell.traffic.evaluation == "exact":
        return [dict(program_reading(cell, s, device, "f32", seconds), control="the program's f32 path")
                for s in seeds]
    return reference_control_readings(cell, seeds)


def bounds(program: list[dict], control: list[dict]) -> dict:
    """For each number, the program's largest reading and the control's smallest."""
    return {k: {"lower": max((r[k] for r in program if k in r), default=None),
                "upper": min((r[k] for r in control if k in r), default=None)} for k in NUMBERS}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--first-seed", type=int, default=7_000_000_000)
    parser.add_argument("--seconds", type=float, default=0.0)
    args = parser.parse_args(argv)
    cell = cells.load_cell(args.workload)
    program = []
    for s in range(args.first_seed, args.first_seed + args.seeds):
        t = time.perf_counter()
        r = program_reading(cell, s, seconds=args.seconds)
        r["seconds"] = time.perf_counter() - t
        program.append(r)
        print(json.dumps({"workload": args.workload, "program": r}), flush=True)
    control = control_readings(cell, list(range(args.first_seed, args.first_seed + args.control_seeds)),
                               args.seconds)
    for r in control:
        print(json.dumps({"workload": args.workload, "control": r}), flush=True)
    print(json.dumps({"workload": args.workload, **bounds(program, control),
                      "limits": {"max_abs_z": judge.MAX_ABS_Z_LIMIT, "repeated_chunks": 0,
                                 "norm_off_share": judge.NORM_OFF_SHARE_LIMIT}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
