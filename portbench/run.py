"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (``BENCHMARK.json``) names a configuration and a traffic mix. The
run compiles the configuration's frozen circuit text with
``tsim_tpu_torch`` on this host, builds a ``CompiledDetectorSampler``
seeded by ``--seed``, warms the cell's own call up until every shard
replays its captured step, then calls ``sample()`` back to back, one caller
in a closed loop, for ``--seconds``. With ``--trace 1`` the profiler is held
over the part of the window that the cell's per-layer metrics state (each
metric file's ``SPAN``, shares of the window; the traced part runs from the
earliest start to the latest end) and the metrics are read from it;
otherwise the end-to-end metrics are taken by the host's clock. After the
window, the rows of a run of consecutive calls (drawn from the seed) are
held against the plain reference's exact distribution (``judge.py``,
``reference/``), and in a cell that asks for exact evaluation so is the
share of the window's calls in which the sampler's own normalization is
off the reference's, 1; these decide ``correct``.

The last line of standard output is the result, one JSON object; the
numbers compared, each with its limit, are the last lines of standard
error and the result's last key, ``checks``. The run exits 2 without a
result where there is no card or too few, and 3 where a module of JAX or of
the JAX package was loaded.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    # Run as a script: import the benchmark as a package from the checkout.
    sys.path = [p for p in sys.path if Path(p or ".").resolve() != ROOT / "portbench"]
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from portbench import cells, judge, tracing  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "tsim_tpu")
COMPILE_CACHE = ROOT / "build" / "portbench" / "compile_cache"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (``tsim_tpu_torch`` is neither)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def clear_share(calls: list[np.ndarray], columns: np.ndarray) -> float:
    """The share of the rows of ``calls`` in which none of ``columns``
    ((n,) bool) is set."""
    total = sum(len(c) for c in calls)
    clear = sum(int(np.count_nonzero(~c[:, columns].any(axis=1))) for c in calls)
    return clear / total if total else 0.0


def make_call(sampler, traffic: cells.Traffic):
    """The cell's ``sample()`` call; "all_detectors" masks every detector."""
    kwargs = {"batch_size": traffic.batch_size, "append_observables": traffic.append_observables}
    if traffic.postselection is not None:
        kwargs["postselection_mask"] = np.ones(sampler._num_detectors, dtype=bool)
    return lambda: sampler.sample(traffic.shots, **kwargs)


def warm_up(sampler, call, postselected: bool) -> int:
    """The cell's own calls until one replays every shard's captured step
    (a size's first batch runs eagerly, its second is captured), then two
    more; a postselected call never captures, so three in all."""
    calls, replayed = 0, postselected
    while calls < 12:
        call()
        calls += 1
        steps = getattr(sampler, "last_batch_steps", None)
        if not postselected and steps and steps.get("eager", 0) == 0 and steps.get("capture", 0) == 0:
            replayed = True
        if replayed and calls >= 3:
            break
    for _ in range(2):
        call()
        calls += 1
    return calls


def work_counts(sampler, evaluation: str) -> dict:
    """The least-work counts of ``counts/work.py`` for the sampler's rungs
    and noise (the program's compiled shapes, read for the per-layer
    rooflines only)."""
    from portbench.counts import work

    rungs = [(c, t) for comp_p, comp_t in zip(sampler._program.components, sampler._tables.components)
             for c, t in zip(comp_p.compiled_scalar_graphs, comp_t.rungs) if c.num_graphs > 0]

    def eval_least_ms(rows: float) -> float:
        total = 0.0
        for c, t in rungs:
            if evaluation == "f32":
                total += work.f32_bound(c, 4 * t.flat.numel(), rows)[0]
            elif t.approximate:
                total += work.approx_bound(c, t, rows)[0]
            else:
                total += work.exact_bound(c, t, rows)[0]
        return total

    ch = sampler._device_channels
    table_bytes = int(np.asarray(ch.table).nbytes)

    def noise_least_ms(rows: float) -> float:
        return work.noise_bound(ch.num_channels, ch.num_f, table_bytes, rows)[0]

    return {"evaluation": evaluation, "eval_launches": len(rungs),
            "eval_least_ms": eval_least_ms, "noise_least_ms": noise_least_ms}


def _devices_used(torch) -> list[int]:
    return [d for d in range(torch.cuda.device_count()) if torch.cuda.max_memory_allocated(d) > 0]


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device=None,
             started: float | None = None, cell: cells.Cell | None = None) -> tuple[dict, dict, dict]:
    """One run of a cell: (the result object, the numbers compared, notes:
    the run's stages (set-up, and reading the trace) and the rows judged).

    ``device`` is passed to the sampler (None: the card, or the cards of
    the traffic's mesh); ``cell`` replaces the one ``BENCHMARK.json``
    names (the tests' small cells)."""
    started = PROCESS_START if started is None else started
    cell = cell or cells.load_cell(name)
    traffic = cell.traffic
    postselected = traffic.postselection is not None
    os.environ.setdefault("TSIM_TPU_COMPILE_CACHE_DIR", str(COMPILE_CACHE))
    Path(os.environ["TSIM_TPU_COMPILE_CACHE_DIR"]).mkdir(parents=True, exist_ok=True)

    import torch

    from tsim_tpu_torch.circuit import Circuit

    stages = {"imports": time.perf_counter() - started}
    on_card = device is None or torch.device(device).type == "cuda"
    circuit = Circuit(cell.config.circuit_text)
    sampler = circuit.compile_detector_sampler(
        seed=seed, device=device, evaluation=traffic.evaluation, mesh=traffic.mesh)
    stages["sampler"] = time.perf_counter() - started - sum(stages.values())
    call = make_call(sampler, traffic)
    stages["warm_calls"] = warm_up(sampler, call, postselected)
    stages["warm_up"] = time.perf_counter() - started - stages["imports"] - stages["sampler"]
    nd = cell.config.num_detectors
    columns = nd + (cell.config.num_observables if traffic.append_observables else 0)
    detectors = np.arange(columns) < nd
    direct = np.zeros(columns, dtype=bool)
    direct[:nd] = np.asarray(sampler._direct_detector_mask, dtype=bool)
    work = work_counts(sampler, traffic.evaluation) if trace else None

    keep, first = judge.kept_calls(traffic.shots), judge.first_kept(seed)
    kept: list[np.ndarray] = []
    durations: list[float] = []
    attempted = failed = rows = 0
    deviations: list = []  # the sampler's normalization monitor after each call
    readers = {m["name"]: cells.metric_reader(m["name"]) for m in cell.per_layer} if trace else {}
    hull = tracing.hull([r.SPAN for r in readers.values()]) if readers else None
    traced_calls: list[dict] = []  # rows and shard steps of each traced call
    tracer = tracing.Tracer(torch, on_card) if hull else None
    tracing_now = traced = False
    traced_at = [0.0, 0.0]  # perf_counter at the traced part's start and end
    window_start = time.perf_counter()
    setup_s = window_start - started
    end = window_start
    while True:
        if hull and not traced and end - window_start >= hull[0] * seconds:
            traced_at[0] = time.perf_counter()
            tracer.record()
            tracing_now = traced = True
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(tracing.CALL) if tracing_now else contextlib.nullcontext():
                out = call()
        except Exception:  # a failed call ends the window and fails the run
            traceback.print_exc()
            attempted += 1
            failed += 1
            end = time.perf_counter()
            break
        end = time.perf_counter()
        attempted += 1
        if out.shape != (traffic.shots, columns) or out.dtype != np.bool_:
            failed += 1
        else:
            rows += traffic.shots
        deviations.append(getattr(sampler, "last_norm_deviation", None))
        if first <= attempted - 1 < first + keep:
            kept.append(out)
        durations.append(end - t0)
        if tracing_now:
            steps = getattr(sampler, "last_batch_steps", None) or {}
            traced_calls.append({"rows": traffic.shots,
                                 "steps": sum(steps.values()) if not postselected else 0})
            if end - window_start >= min(hull[1] * seconds, seconds):
                traced_at[1] = time.perf_counter()
                tracer.stop()
                tracing_now = False
        if end - window_start >= seconds:
            break
        del out
    if tracing_now:
        traced_at[1] = time.perf_counter()
    wall = end - window_start
    if tracer is not None:
        tracer.stop()
        stages["trace_stop"] = time.perf_counter() - end
    # The judged calls give the postselected cell its share of survivors
    # (no detector fired) and of rows the ladder evaluates (no direct
    # detector fired), counted after the window so that the caller's count
    # takes nothing from it; 2^24 judged rows put its error under 3e-5.
    judged = [k for k in kept if k.shape == (traffic.shots, columns)]
    survivors = rows * clear_share(judged, detectors) if postselected else 0
    evaluated_share = clear_share(judged, direct) if postselected else 1.0
    for c in traced_calls:
        c["evaluated_rows"] = c["rows"] * evaluated_share

    if on_card:
        used = _devices_used(torch)
        peak = max(torch.cuda.max_memory_allocated(d) for d in used)
        dev_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(used[0]), "count": len(used),
                    "memory_peak_bytes": int(peak)}
    else:
        used = []
        dev_info = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}

    metrics: dict[str, dict] = {}
    breakdown = None
    if traced:
        clock = time.perf_counter()
        record = tracing.record_from(tracer.stopped)
        del tracer
        stages["trace_events"] = time.perf_counter() - clock
        stages["device_events"], stages["host_events"] = len(record["device"]), len(record["host"])
        shares = tuple((t - window_start) / seconds for t in traced_at)
        record.update(devices=used or [0], work=work, shares=shares,
                      calls=tracing.calls_on_trace(record, traced_calls))
        record.update(tracing.counts(record["calls"]))
        clock = time.perf_counter()
        for m in cell.per_layer:
            value = readers[m["name"]].read(tracing.span_view(record, readers[m["name"]].SPAN))
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        stages["trace_metrics"] = time.perf_counter() - clock
        clock = time.perf_counter()
        busy = [tracing.busy_s(record, d) for d in record["devices"]]
        dev_info["busy_s"] = sum(busy) / len(busy)
        dev_info["window_s"] = tracing.window_s(record)
        breakdown = {"device_ops": tracing.device_ops(record),
                     "idle_gaps": tracing.idle_gaps(record, record["devices"][0])}
        del record
        stages["trace_breakdown"] = time.perf_counter() - clock
    elif not trace:
        rate = rows / wall if wall > 0 else 0.0
        values = {
            "shots_per_s": rate,
            "survivors_per_s": survivors / wall if wall > 0 else 0.0,
            "call_ms_p95": (statistics.quantiles([d * 1e3 for d in durations], n=20)[-1]
                            if len(durations) >= 2 else 1e3 * max(durations, default=wall)),
            "setup_s": setup_s,
        }
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    # The program's state goes before the reference runs.
    del call, sampler
    if on_card:
        torch.cuda.empty_cache()
    checks = judge_rows(cell, kept, judge.off_share(deviations) if traffic.evaluation == "exact" else None)
    correct = failed == 0 and bool(kept) and judge.passed(checks)
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v["value"], "limit": v["limit"]} for k, v in checks.items()}
    notes = {"setup": stages, "rows_judged": sum(len(k) for k in kept)}
    return result, checks, notes


def judge_rows(cell: cells.Cell, kept: list[np.ndarray], off_share: float | None = None) -> dict:
    """The numbers compared for the judged calls' rows, and the share of
    calls whose normalization was off (``off_share``, None where it is not
    compared). The reference runs on the host's CPU, after the program's
    state is freed."""
    from portbench.reference.density import output_distribution

    traffic = cell.traffic
    nd = cell.config.num_detectors
    q, lay = output_distribution(cell.config.circuit_text)
    if (lay.num_detectors, lay.num_observables) != (nd, cell.config.num_observables):
        raise ValueError(f"{cell.config.name}: the circuit has {lay.num_detectors} detectors and "
                         f"{lay.num_observables} observables, its file says {nd} and "
                         f"{cell.config.num_observables}")
    columns = nd + (cell.config.num_observables if traffic.append_observables else 0)
    q = judge.marginal(q, nd, traffic.append_observables)
    good = [k for k in kept if k.shape[1:] == (columns,)]
    hist = judge.histogram(good, columns)
    return judge.checks_of(hist, q, columns, nd, traffic.postselection is not None,
                           judge.repeated_chunks(good), off_share)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = cells.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s), found {found}", file=sys.stderr)
        return 2
    result, checks, notes = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), cell=cell)
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: modules of JAX or the JAX package were loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    print("stages: " + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                                for k, v in notes["setup"].items()), file=sys.stderr)
    for k, c in checks.items():
        extra = f" ({c['event']}, {c['events']} events, {notes['rows_judged']} rows)" if "event" in c else ""
        print(f"check {k}: {c['value']} limit {c['limit']}{extra}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
