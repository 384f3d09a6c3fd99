#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tsim_tpu_torch) once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero:

1. the card's name and power limit (``nvidia-smi``); no CUDA means exit 1;
2. build of the CUDA kernel library from the sources in this checkout;
3. kernel vs plain PyTorch version on every d3 distillation rung at the
   main path's shape (2^20 seeded rows plus a probe row, as one ladder
   call of a 2^20-shot batch), within rtol 1e-5 of the row's magnitude
   (atol 1e-8); on the same inputs both are timed with CUDA events on the
   first 103-graph rung (wide) and the 6-graph rung (small);
4. the main path: ``distillation_d3(p=0.05).compile_detector_sampler(
   seed=0, device="cuda").sample(8 * 2**20, batch_size=2**20,
   append_observables=True)``, with the kernels' launch counts, the norm
   deviation (at most 3e-3), shots/s, and per-output z-scores against the
   means tsim_tpu sampled (pooled sigma, at most 4 * sqrt(2));
5. the exact kernels vs the plain exact evaluator on every rung of the
   cultivation program, the d3 program and the d3 state-probability
   program, at 2^20 + 1 seeded rows: exact kernels give equal magnitudes,
   approximate ones agree within rtol 1e-5 of the row's magnitude; each
   kernel and the plain version are timed with CUDA events on one rung;
6. state probabilities: ``distillation_d3(p=0.05).compile_state_probs(
   seed=0, device="cuda").probability_of(state, batch_size=2**20)`` for
   the exported states (values finite, in [0, 1]; calls/s and rows/s), and
   ``_probability_body`` on the exported noise rows against tsim_tpu's
   values (rtol 1e-5);
7. exact-mode sampling: ``cultivation_d3(p=0.001, checks=2)
   .compile_detector_sampler(seed=0, device="cuda", evaluation="exact")
   .sample(4 * 2**20, batch_size=2**20)`` (norm deviation at most 1e-5,
   shots/s), the exported 4096-shot replay of tsim_tpu's exact sampling
   reproduced bit for bit, and one 2^20-shot batch of d3 distillation in
   exact mode (norm deviation, z-scores as in phase 4).

Each path of phases 4, 6 and 7 runs with the launch counts set to 0 just
before it and read just after; a kernel of the path that was not launched
fails the run. The line before the last is a JSON summary of the kernels;
the last line is ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

RTOL, ATOL = 1e-5, 1e-8
NORM_TOL = 3e-3
Z_BOUND = 4 * math.sqrt(2)
MAIN_BATCH = 1 << 20
MAIN_SHOTS = 8 * MAIN_BATCH
KERNEL_ROWS = MAIN_BATCH + 1  # one ladder call: the batch plus the probe row
SOURCE = "tsim_tpu_torch/kernels/csrc/sample_eval.cu"
REPLACES = {
    "wide": "tsim_tpu/compile/pallas_sample.py:356",  # _kernel_sample
    "small": "tsim_tpu/compile/pallas_sample.py:374",  # _kernel_sample_t
}
EXACT_NORM_TOL = 1e-5
EXACT_SOURCE = "tsim_tpu_torch/kernels/csrc/exact_eval.cu"
EXACT_REPLACES = {
    "exact_wide": "tsim_tpu/compile/pallas_evaluate.py:270",  # _kernel_exact (K5)
    "approx_wide": "tsim_tpu/compile/pallas_evaluate.py:301",  # _kernel_approx (K6)
    "exact_small": "tsim_tpu/compile/pallas_evaluate.py:814",  # _kernel_exact_t (K7a)
    "approx_small": "tsim_tpu/compile/pallas_evaluate.py:842",  # _kernel_approx_t (K7b)
}
# (program, graphs) of the rung each exact kernel is timed on.
EXACT_TIMED = {
    "exact_wide": ("cultivation", 307),
    "exact_small": ("cultivation", 4),
    "approx_wide": ("d3_state_probs", 172),
    "approx_small": ("d3", 6),
}
CULTIVATION_SHOTS = 4 * MAIN_BATCH
DEVICE = "cuda"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def rows(n_params: int, count: int, seed: int, device):
    """``count`` seeded 0/1 rows whose last one is row 0 with its last bit cleared."""
    x = np.random.default_rng(seed).integers(0, 2, size=(count, n_params)).astype(np.uint8)
    x[-1] = x[0]
    if n_params:
        x[-1, -1] = 0
    return torch.from_numpy(x).to(device)


def time_ms(fn, reps: int = 5) -> float:
    """Mean milliseconds per call, with CUDA events, after one warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_once(fn):
    """(result, milliseconds) of one call, with CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def check_means(label: str, out: np.ndarray, exported) -> None:
    """Per-output z-scores of ``out``'s means against the means tsim_tpu sampled."""
    ref = np.asarray(exported.reference_means, np.float64)
    n_ref = int(exported.meta["reference_shots"])
    shots = out.shape[0]
    means = out.mean(axis=0, dtype=np.float64)
    pooled = (means * shots + ref * n_ref) / (shots + n_ref)
    sigma = np.sqrt(np.maximum(pooled * (1 - pooled), 1e-12) * (1 / shots + 1 / n_ref))
    z = np.abs(means - ref) / sigma
    print(f"{label}: means  " + " ".join(f"{m:.4f}" for m in means))
    print(f"{label}: tsim_tpu " + " ".join(f"{m:.4f}" for m in ref))
    print(f"{label}: z      " + " ".join(f"{v:.2f}" for v in z) + f" (max {z.max():.2f}, bound {Z_BOUND:.2f})")
    if not (z < Z_BOUND).all():
        fail(f"{label}: an output's mean disagrees with tsim_tpu's beyond 4 * sqrt(2) sigma")


def check_launched(label: str, launches: dict, expected) -> None:
    print(f"{label}: kernel launches {launches}", flush=True)
    missing = [k for k in expected if launches[k] <= 0]
    if missing:
        fail(f"{label}: kernels {missing} of the path were not launched")


def exact_kernel_phase(programs: dict, dev) -> tuple[dict, dict]:
    """Phase 5: each exact kernel vs the plain exact evaluator on every rung
    at KERNEL_ROWS rows, and the timings of EXACT_TIMED.

    Returns ({kernel: max abs err}, {kernel: (kernel ms, plain ms)}).
    """
    from tsim_tpu_torch.compile.evaluate import evaluate_abs
    from tsim_tpu_torch.compile.exact_eval import evaluate_abs_exact
    from tsim_tpu_torch.compile.exact_tables import ExactTables
    from tsim_tpu_torch.kernels import exact_eval as kernel

    max_abs = dict.fromkeys(kernel.launch_counts, 0.0)
    timing = {}
    seed = 200
    for label, exported in programs.items():
        rungs = [c for comp in exported.program.components for c in comp.compiled_scalar_graphs]
        for i, csg in enumerate(rungs):
            t = ExactTables(csg).to(dev)
            name = f"{'approx' if t.approximate else 'exact'}_{kernel.configuration(t.num_graphs)}"
            x = rows(t.n_params, KERNEL_ROWS, seed=seed, device=dev)
            seed += 1
            got = evaluate_abs_exact(t, x)
            want = evaluate_abs(t.circuit(), x)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                fail(f"{label} rung {i}: kernel output is not finite")
            err = (got - want).abs()
            if t.approximate:
                ok = bool((err <= ATOL + RTOL * want).all())
                bound = f"rtol {RTOL}"
            else:
                ok = torch.equal(got, want)
                bound = "equal"
            max_abs[name] = max(max_abs[name], float(err.max()))
            rel = float((err / want.clamp_min(1e-30)).max())
            print(
                f"{label} rung {i}: G={t.num_graphs} P={t.n_params} {name}, B={KERNEL_ROWS}: "
                f"max rel err {rel:.3e}, max abs err {float(err.max()):.3e} ({bound}) "
                f"-> {'ok' if ok else 'FAIL'}",
                flush=True,
            )
            if not ok:
                fail(f"{label} rung {i}: {name} disagrees with the plain exact evaluator")
            del got, want, err
            if EXACT_TIMED[name] == (label, t.num_graphs) and name not in timing:
                # In turns, plain, kernel, kernel, plain; the check above
                # was the plain version's warm-up, and it is slow enough
                # to be timed once per turn.
                partials = kernel.approx_partials if t.approximate else kernel.exact_partials
                _, p1 = timed_once(lambda: evaluate_abs(t.circuit(), x))
                k1 = time_ms(lambda: partials(t, x))
                d1 = time_ms(lambda: evaluate_abs_exact(t, x))
                k2 = time_ms(lambda: partials(t, x))
                _, p2 = timed_once(lambda: evaluate_abs(t.circuit(), x))
                timing[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
                print(
                    f"time at B={KERNEL_ROWS}, {label} G={t.num_graphs} ({name}): kernel "
                    f"{k1:.4f} / {k2:.4f} ms, dispatch with the partials' combine {d1:.4f} ms, "
                    f"plain {p1:.2f} / {p2:.2f} ms",
                    flush=True,
                )
            del t, x
            torch.cuda.empty_cache()
    if set(timing) != set(EXACT_TIMED):
        fail(f"no rung with the timed graph counts {EXACT_TIMED}")
    return max_abs, timing


def state_probs_path(circuit) -> dict:
    """Phase 6: state probabilities of d3 distillation on the card."""
    from tsim_tpu_torch.kernels import exact_eval as kernel

    replay = circuit.load_state_probs().replay
    states = replay["states"]
    sp = circuit.compile_state_probs(seed=0, device=DEVICE)
    sp.probability_of(states[0], batch_size=1024)  # warm-up
    torch.cuda.synchronize()
    kernel.reset_launch_counts()
    t0 = time.perf_counter()
    probs = [sp.probability_of(s, batch_size=MAIN_BATCH) for s in states]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernel.launch_counts)
    check_launched("state probs", launches, ["exact_small", "approx_wide"])
    for i, p in enumerate(probs):
        if p.shape != (MAIN_BATCH,) or not (np.isfinite(p).all() and (p >= 0).all() and (p <= 1).all()):
            fail(f"state probs: state {i}: values not finite in [0, 1] or of the wrong shape")
        print(f"state probs: state {i}: mean {p.mean():.6e}, max {p.max():.6e}, nonzero {np.mean(p > 0):.4f}")
    n = len(states)
    print(
        f"state probs: {n} calls of {MAIN_BATCH} rows in {wall:.3f} s = {n / wall:.2f} calls/s, "
        f"{n * MAIN_BATCH / wall:.0f} rows/s",
        flush=True,
    )
    f = torch.from_numpy(replay["f"]).to(DEVICE)
    worst = 0.0
    for i, s in enumerate(states):
        got = sp._probability_body(f, s).cpu().numpy()
        want = replay["probabilities"][i]
        err = np.abs(got - want)
        worst = max(worst, float((err / np.maximum(want, 1e-30)).max()))
        if not (err <= RTOL * want).all():
            fail(f"state probs: state {i}: replay rows disagree with tsim_tpu beyond rtol {RTOL}")
    print(f"state probs: {f.shape[0]} replay rows x {n} states vs tsim_tpu: max rel err {worst:.3e} -> ok")
    return launches


def exact_sampling_path(cultivation, d3) -> tuple[dict, dict]:
    """Phase 7: exact-mode sampling of 2-check cultivation, its replay, and
    one batch of d3 distillation in exact mode."""
    from tsim_tpu_torch.kernels import exact_eval as kernel
    from tsim_tpu_torch.sampler import sample_program_with_deviation

    exported = cultivation.load()
    sampler = cultivation.compile_detector_sampler(seed=0, device=DEVICE, evaluation="exact")
    sampler.sample(MAIN_BATCH, batch_size=MAIN_BATCH)  # warm-up
    torch.cuda.synchronize()
    kernel.reset_launch_counts()
    t0 = time.perf_counter()
    out = sampler.sample(CULTIVATION_SHOTS, batch_size=MAIN_BATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cult_launches = dict(kernel.launch_counts)
    check_launched("cultivation exact", cult_launches, ["exact_wide", "exact_small"])
    print(f"cultivation exact: shape {out.shape}, dtype {out.dtype}; detector means "
          + " ".join(f"{m:.4f}" for m in out.mean(axis=0)), flush=True)
    if out.shape != (CULTIVATION_SHOTS, exported.num_detectors) or out.dtype != np.bool_:
        fail(f"cultivation exact: expected ({CULTIVATION_SHOTS}, {exported.num_detectors}) bool samples")
    dev_norm = sampler.last_norm_deviation
    print(f"cultivation exact: max norm deviation {dev_norm:.3e} (limit {EXACT_NORM_TOL})", flush=True)
    if not (math.isfinite(dev_norm) and dev_norm <= EXACT_NORM_TOL):
        fail("cultivation exact: norm deviation above the exact tolerance")
    print(
        f"cultivation exact: {CULTIVATION_SHOTS} shots in {wall:.3f} s = "
        f"{CULTIVATION_SHOTS / wall:.0f} shots/s (batch {MAIN_BATCH})",
        flush=True,
    )

    r = exported.replay
    f = sampler._device_channels.sample_from_uniforms(torch.from_numpy(r["noise_uniforms"]).to(DEVICE))
    draws = [torch.from_numpy(d).to(DEVICE) for d in r["draw_uniforms"]]
    bits, dev = sample_program_with_deviation(sampler._tables, f, None, uniforms=draws)
    bits = bits.cpu().numpy()
    differ = int((bits != r["bits"]).any(axis=1).sum())
    print(f"cultivation exact: replay of {len(bits)} tsim_tpu shots: {differ} rows differ, "
          f"norm deviation {float(dev[0]):.3e}", flush=True)
    if bits.shape != r["bits"].shape or differ:
        fail("cultivation exact: the replay does not reproduce tsim_tpu's bits")

    d3_sampler = d3.compile_detector_sampler(seed=0, device=DEVICE, evaluation="exact")
    d3_sampler.sample(1024, batch_size=1024)  # warm-up
    torch.cuda.synchronize()
    kernel.reset_launch_counts()
    t0 = time.perf_counter()
    out = d3_sampler.sample(MAIN_BATCH, batch_size=MAIN_BATCH, append_observables=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    d3_launches = dict(kernel.launch_counts)
    check_launched("d3 exact", d3_launches, ["approx_small", "approx_wide", "exact_small"])
    dev_norm = d3_sampler.last_norm_deviation
    print(f"d3 exact: max norm deviation {dev_norm:.3e} (limit {EXACT_NORM_TOL}); "
          f"{MAIN_BATCH} shots in {wall:.3f} s = {MAIN_BATCH / wall:.0f} shots/s", flush=True)
    if not (math.isfinite(dev_norm) and dev_norm <= EXACT_NORM_TOL):
        fail("d3 exact: norm deviation above the exact tolerance")
    check_means("d3 exact", out, d3.load())
    return cult_launches, d3_launches


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check runs only on a CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device 0: {kind}", flush=True)
    # The plain version's parity matmul stays in full f32 (0/1 inputs are
    # exact in TF32 too, but the reference states its precision).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from tsim_tpu_torch.compile.sample_eval import sample_product_sum_reference
    from tsim_tpu_torch.compile.sample_tables import SampleTables
    from tsim_tpu_torch.kernels import build
    from tsim_tpu_torch.kernels import sample_eval as kernel
    from tsim_tpu_torch.models import distillation_d3

    # ---- phase 2: build -------------------------------------------------
    t0 = time.perf_counter()
    lib_path = build.build()
    build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib_path}", flush=True)
    for line in (lib_path.parent / "ptxas.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # ---- phase 3: kernel vs plain version -------------------------------
    circuit = distillation_d3(p=0.05)
    exported = circuit.load()
    rungs = exported.program.components[0].compiled_scalar_graphs
    dev = torch.device("cuda")
    tables = [SampleTables(c).to(dev) for c in rungs]
    max_abs = {"wide": 0.0, "small": 0.0}
    timing = {}
    timed = {"wide": 103, "small": 6}  # graphs of the rung timed per configuration
    for i, t in enumerate(tables):
        x = rows(t.n_params, KERNEL_ROWS, seed=100 + i, device=dev)
        got = kernel.sample_product_sum(t, x)
        want = sample_product_sum_reference(t, x)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail(f"rung {i}: kernel output is not finite")
        err = (got - want).abs()
        scale = want.norm(dim=1, keepdim=True)
        rel = float((err / scale.clamp_min(1e-30)).max())
        ok = bool((err <= ATOL + RTOL * scale).all())
        config = kernel.configuration(t.num_graphs)
        max_abs[config] = max(max_abs[config], float(err.max()))
        print(
            f"rung {i}: G={t.num_graphs} P={t.n_params} {config}, B={KERNEL_ROWS}: "
            f"max rel err {rel:.3e}, max abs err {float(err.max()):.3e} -> {'ok' if ok else 'FAIL'}",
            flush=True,
        )
        if not ok:
            fail(f"rung {i}: kernel disagrees with the plain version beyond rtol {RTOL}")
        del got, want, err, scale
        if timed[config] == t.num_graphs and config not in timing:
            k1 = time_ms(lambda: kernel.sample_product_sum(t, x))
            p1 = time_ms(lambda: sample_product_sum_reference(t, x))
            k2 = time_ms(lambda: kernel.sample_product_sum(t, x))
            p2 = time_ms(lambda: sample_product_sum_reference(t, x))
            timing[config] = ((k1 + k2) / 2, (p1 + p2) / 2)
            print(
                f"time at B={KERNEL_ROWS}, G={t.num_graphs} ({config}): kernel {k1:.4f} / "
                f"{k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms",
                flush=True,
            )
    if set(timing) != set(timed):
        fail(f"no rung with the timed graph counts {timed}")
    del tables
    torch.cuda.empty_cache()

    # ---- phase 4: the main path -----------------------------------------
    sampler = circuit.compile_detector_sampler(seed=0, device="cuda")
    sampler.sample(MAIN_BATCH, batch_size=MAIN_BATCH, append_observables=True)  # warm-up
    torch.cuda.synchronize()
    kernel.reset_launch_counts()
    t0 = time.perf_counter()
    out = sampler.sample(MAIN_SHOTS, batch_size=MAIN_BATCH, append_observables=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernel.launch_counts)
    n_out = exported.program.num_outputs
    print(f"slice: shape {out.shape}, dtype {out.dtype}", flush=True)
    if out.shape != (MAIN_SHOTS, n_out) or out.dtype != np.bool_:
        fail(f"expected ({MAIN_SHOTS}, {n_out}) bool samples")
    dev_norm = sampler.last_norm_deviation
    print(f"slice: max norm deviation {dev_norm:.3e} (limit {NORM_TOL})", flush=True)
    if not (math.isfinite(dev_norm) and dev_norm <= NORM_TOL):
        fail("norm deviation above the f32 tolerance")
    print(f"slice: kernel launches {launches}", flush=True)
    if min(launches.values()) <= 0:
        fail("a kernel of the main path was not launched")
    print(
        f"slice: {MAIN_SHOTS} shots in {wall:.3f} s = {MAIN_SHOTS / wall:.0f} shots/s "
        f"(batch {MAIN_BATCH}, {kind})",
        flush=True,
    )

    check_means("slice", out, exported)
    del sampler, out
    torch.cuda.empty_cache()

    # ---- phase 5: exact kernels vs plain exact evaluator ----------------
    from tsim_tpu_torch.models import cultivation_d3

    cultivation = cultivation_d3(p=0.001, checks=2)
    exact_err, exact_timing = exact_kernel_phase(
        {
            "cultivation": cultivation.load(),
            "d3": exported,
            "d3_state_probs": circuit.load_state_probs(),
        },
        dev,
    )

    # ---- phase 6: state probabilities -----------------------------------
    paths = [state_probs_path(circuit)]

    # ---- phase 7: exact-mode sampling -----------------------------------
    paths += exact_sampling_path(cultivation, circuit)
    exact_launches = {k: sum(p[k] for p in paths) for k in exact_err}

    entries = [
        {
            "name": f"sample_eval_{config}",
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES[config],
            "launches": launches[config],
            "max_abs_err": max_abs[config],
            "ms": timing[config][0],
            "plain_ms": timing[config][1],
        }
        for config in ("wide", "small")
    ]
    entries += [
        {
            "name": name,
            "route": "cuda",
            "source": EXACT_SOURCE,
            "replaces": EXACT_REPLACES[name],
            "launches": exact_launches[name],
            "max_abs_err": exact_err[name],
            "ms": exact_timing[name][0],
            "plain_ms": exact_timing[name][1],
        }
        for name in EXACT_REPLACES
    ]
    print(json.dumps({"kernels": entries}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
