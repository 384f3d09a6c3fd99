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
   means tsim_tpu sampled (pooled sigma, at most 4 * sqrt(2)).

The line before the last is a JSON summary of the kernels; the last line
is ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
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

    ref = np.asarray(exported.reference_means, np.float64)
    n_ref = int(exported.meta["reference_shots"])
    means = out.mean(axis=0, dtype=np.float64)
    pooled = (means * MAIN_SHOTS + ref * n_ref) / (MAIN_SHOTS + n_ref)
    sigma = np.sqrt(np.maximum(pooled * (1 - pooled), 1e-12) * (1 / MAIN_SHOTS + 1 / n_ref))
    z = np.abs(means - ref) / sigma
    print("slice: means  " + " ".join(f"{m:.4f}" for m in means))
    print("slice: tsim_tpu " + " ".join(f"{m:.4f}" for m in ref))
    print(f"slice: z      " + " ".join(f"{v:.2f}" for v in z) + f" (max {z.max():.2f}, bound {Z_BOUND:.2f})")
    if not (z < Z_BOUND).all():
        fail("an output's mean disagrees with tsim_tpu's beyond 4 * sqrt(2) sigma")

    print(json.dumps({"kernels": [
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
    ]}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
