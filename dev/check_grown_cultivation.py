"""Normalization of 2-check grown cultivation under the port's plain exact evaluator.

tsim_tpu's exact CPU path warns of a marginal-normalization deviation of
6.7e-1 on ``cultivation_d3_grown(p=0.001, checks=2)``. This script tells
a compilation fault from an evaluation fault. It compiles the circuit
with tsim_tpu (about 40 s on a CPU), converts the program with
``program_io.from_reference``, and walks every component's ladder on
seeded noise and seeded draws. At each rung it evaluates both
continuations of every row's drawn prefix twice: with the port's plain
exact evaluator (``tsim_tpu_torch.compile.evaluate.evaluate_abs``) and
with tsim_tpu's (``tsim_tpu.compile.evaluate.evaluate_abs``). It prints,
per rung, the largest normalization deviation
``|(p(prefix, 0) + p(prefix, 1)) / p(prefix) - 1|`` under each evaluator
and their largest relative disagreement. Where both evaluators agree and
both deviate, the compiled program is at fault; where only tsim_tpu's
deviates, its evaluation is. Needs JAX; runs on the CPU:

    JAX_PLATFORMS=cpu python dev/check_grown_cultivation.py [--shots 256]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import jax.numpy as jnp
    import numpy as np
    import torch

    from tsim_tpu.compile.evaluate import evaluate_abs as jax_evaluate_abs
    from tsim_tpu.models.cultivation import cultivation_d3_grown
    from tsim_tpu_torch.compile.evaluate import evaluate_abs
    from tsim_tpu_torch.noise.device_channels import DeviceChannelSampler
    from tsim_tpu_torch.program_io import from_reference

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--shots", type=int, default=256)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    t0 = time.perf_counter()
    sampler = cultivation_d3_grown(p=0.001, checks=2).compile_detector_sampler(seed=args.seed)
    exported = from_reference(sampler._program, sampler._channel_sampler, sampler._num_detectors)
    print(f"compiled in {time.perf_counter() - t0:.1f} s", flush=True)

    rng = np.random.default_rng(args.seed)
    noise = DeviceChannelSampler(exported.noise, "cpu")
    u = rng.random((args.shots, noise.num_channels), dtype=np.float32)
    f = noise.sample_from_uniforms(torch.from_numpy(u)).numpy()

    def both(port_csg, ref_csg, rows):
        port = evaluate_abs(port_csg, torch.from_numpy(rows)).numpy().astype(np.float64)
        ref = np.asarray(jax_evaluate_abs(ref_csg, jnp.asarray(rows)), np.float64)
        return port, ref

    worst = {"port": 0.0, "tsim_tpu": 0.0}
    for ci, (comp, ref_comp) in enumerate(zip(exported.program.components, sampler._program.components)):
        rungs, ref_rungs = comp.compiled_scalar_graphs, ref_comp.compiled_scalar_graphs
        prefix = f[:, np.asarray(comp.f_selection)]
        prev = dict(zip(("port", "tsim_tpu"), both(rungs[0], ref_rungs[0], prefix)))
        for k in range(1, len(rungs)):
            t0 = time.perf_counter()
            col = np.ones((args.shots, 1), np.uint8)
            one = dict(zip(("port", "tsim_tpu"), both(rungs[k], ref_rungs[k], np.hstack([prefix, col]))))
            zero = dict(zip(("port", "tsim_tpu"), both(rungs[k], ref_rungs[k], np.hstack([prefix, 0 * col]))))
            line = [f"component {ci} rung {k}: G={rungs[k].num_graphs} P={rungs[k].n_params}"]
            for name in ("port", "tsim_tpu"):
                ok = prev[name] > 0
                dev = np.abs((one[name] + zero[name])[ok] / prev[name][ok] - 1).max(initial=0.0)
                worst[name] = max(worst[name], dev)
                line.append(f"{name} max deviation {dev:.3e}")
            both_mags = np.concatenate([one["port"], zero["port"]])
            ref_mags = np.concatenate([one["tsim_tpu"], zero["tsim_tpu"]])
            rel = np.abs(both_mags - ref_mags) / np.maximum(np.abs(ref_mags), 1e-300)
            line.append(f"largest relative disagreement {rel.max():.3e}")
            line.append(f"({time.perf_counter() - t0:.1f} s)")
            print(", ".join(line), flush=True)
            # Draw the next bit from the port's probabilities.
            p_one = np.clip(one["port"] / np.maximum(prev["port"], 1e-300), 0, 1)
            bit = (rng.random(args.shots) < p_one).astype(np.uint8)[:, None]
            prefix = np.hstack([prefix, bit])
            prev = {name: np.where(bit[:, 0] == 1, one[name], zero[name]) for name in prev}
    print(f"largest deviation over all rungs: port {worst['port']:.3e}, tsim_tpu {worst['tsim_tpu']:.3e}")


if __name__ == "__main__":
    main()
