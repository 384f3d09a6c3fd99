"""Export d3 distillation, compiled by tsim_tpu, as data for tsim_tpu_torch.

Compiles ``tsim_tpu.models.distillation.distillation_d3(p=0.05)`` with
``compile_detector_sampler(seed=0)``, converts the program and its noise
channels with ``tsim_tpu_torch.program_io.from_reference``, and adds the
per-output means of tsim_tpu's own sampler (detectors then observables)
as the physics reference for runs where JAX is absent. Needs JAX; runs on
the CPU:

    JAX_PLATFORMS=cpu python dev/export_torch_program.py
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REFERENCE_SHOTS = 1 << 18
REFERENCE_BATCH = 1 << 16
SEED = 0


def compile_d3():
    """The tsim_tpu detector sampler of d3 distillation at p = 0.05, seed 0."""
    from tsim_tpu.models.distillation import distillation_d3

    return distillation_d3(p=0.05).compile_detector_sampler(seed=SEED)


def export_sampler(sampler):
    """A tsim_tpu sampler's program and noise as a tsim_tpu_torch ExportedProgram."""
    from tsim_tpu_torch.program_io import from_reference

    return from_reference(sampler._program, sampler._channel_sampler, sampler._num_detectors)


def main() -> None:
    from tsim_tpu_torch.models.distillation import D3_PROGRAM
    from tsim_tpu_torch.program_io import save_npz

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=str(D3_PROGRAM))
    parser.add_argument("--shots", type=int, default=REFERENCE_SHOTS)
    args = parser.parse_args()

    t0 = time.perf_counter()
    sampler = compile_d3()
    exported = export_sampler(sampler)
    print(f"compiled in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    t0 = time.perf_counter()
    samples = sampler.sample(args.shots, batch_size=REFERENCE_BATCH, append_observables=True)
    print(f"sampled {args.shots} shots in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    exported = dataclasses.replace(
        exported,
        reference_means=samples.mean(axis=0),
        meta={
            "circuit": "tsim_tpu.models.distillation.distillation_d3(p=0.05)",
            "compile": f"compile_detector_sampler(seed={SEED})",
            "reference": "sample(shots, batch_size=65536, append_observables=True), "
            "tsim_tpu on the CPU (exact evaluation)",
            "reference_shots": args.shots,
        },
    )
    save_npz(args.out, exported)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)", file=sys.stderr)


if __name__ == "__main__":
    main()
