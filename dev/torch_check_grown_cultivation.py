"""Normalization of noisy grown cultivation, compiled and evaluated by the port alone.

``cultivation_d3_grown(p=0.001, checks=2)`` is the widest circuit the port
compiles (12 rungs, up to 1084 graphs). This script compiles it with
``tsim_tpu_torch`` on the CPU, draws seeded noise through
``DeviceChannelSampler.sample_from_uniforms`` and walks every component's
ladder with the plain exact evaluator (``compile/evaluate.py::evaluate_abs``).
At each rung it evaluates both continuations of every row's drawn prefix and
prints G, P and the largest normalization deviation
``|(p(prefix, 0) + p(prefix, 1)) / p(prefix) - 1|``; the next bit is drawn
from those probabilities. In exact arithmetic a right program gives 0 up
to the float32 magnitude's rounding (about 1e-6). Imports neither JAX nor
tsim_tpu; about 70 s on a CPU (2-check; the compile is 50 s of it):

    python dev/torch_check_grown_cultivation.py [--checks 1|2] [--shots 4096]

Exits 1 when a rung deviates by more than ``--tolerance``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def ladder_deviations(program, noise, shots: int, seed: int):
    """Per component and rung (component, rung, G, P, largest deviation),
    over ``shots`` seeded noisy shots, with the plain exact evaluator."""
    import numpy as np
    import torch

    from tsim_tpu_torch.compile.evaluate import evaluate_abs
    from tsim_tpu_torch.noise.device_channels import DeviceChannelSampler

    rng = np.random.default_rng(seed)
    channels = DeviceChannelSampler(noise, "cpu")
    u = rng.random((shots, channels.num_channels), dtype=np.float32)
    f = channels.sample_from_uniforms(torch.from_numpy(u)).numpy()

    def mags(rung, rows):
        return evaluate_abs(rung, torch.from_numpy(rows)).numpy().astype(np.float64)

    out = []
    for ci, comp in enumerate(program.components):
        rungs = comp.compiled_scalar_graphs
        prefix = f[:, np.asarray(comp.f_selection)]
        prev = mags(rungs[0], prefix)
        for k in range(1, len(rungs)):
            col = np.ones((shots, 1), np.uint8)
            one = mags(rungs[k], np.hstack([prefix, col]))
            zero = mags(rungs[k], np.hstack([prefix, 0 * col]))
            ok = prev > 0
            dev = float(np.abs((one + zero)[ok] / prev[ok] - 1).max(initial=0.0))
            out.append((ci, k, int(rungs[k].num_graphs), int(rungs[k].n_params), dev))
            p_one = np.clip(one / np.maximum(prev, 1e-300), 0, 1)
            bit = (rng.random(shots) < p_one).astype(np.uint8)[:, None]
            prefix = np.hstack([prefix, bit])
            prev = np.where(bit[:, 0] == 1, one, zero)
    return out


def main() -> int:
    from tsim_tpu_torch.models import cultivation_d3_grown
    from tsim_tpu_torch.sampler import compile_circuit

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--checks", type=int, default=2)
    parser.add_argument("--p", type=float, default=0.001)
    parser.add_argument("--shots", type=int, default=4096)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--tolerance", type=float, default=1e-5)
    args = parser.parse_args()

    t0 = time.perf_counter()
    circuit = cultivation_d3_grown(p=args.p, checks=args.checks)
    exported, stats = compile_circuit(circuit, sample_detectors=True, mode="sequential")
    print(f"compiled in {time.perf_counter() - t0:.1f} s: {stats}", flush=True)
    t0 = time.perf_counter()
    worst = 0.0
    for ci, k, g, p, dev in ladder_deviations(exported.program, exported.noise, args.shots, args.seed):
        worst = max(worst, dev)
        print(f"component {ci} rung {k}: G={g} P={p} max deviation {dev:.3e}", flush=True)
    print(f"walked {args.shots} shots in {time.perf_counter() - t0:.1f} s")
    print(f"largest deviation over all rungs: {worst:.3e} (tolerance {args.tolerance:.0e})")
    return int(worst > args.tolerance)


if __name__ == "__main__":
    sys.exit(main())
