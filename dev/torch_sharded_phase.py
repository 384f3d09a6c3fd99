"""Phase 23 of ``chip_smoke.py`` (the sharded path) alone, after phase 4's
unsharded d3 run that it is held against: the check of ``mesh=`` on a
machine of several cards (a mesh of every card; of two replicas of card 0
on a machine of one), without the other phases.

    python3 dev/torch_sharded_phase.py

Prints the cards' names and power limits, phase 4's shots/s and launches,
then phase 23's lines; exits non-zero where a check of phase 23 fails.
Needs a CUDA device and the committed programs.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import numpy as np
    import torch

    import chip_smoke as cs
    from tsim_tpu_torch.kernels import build
    from tsim_tpu_torch.kernels import sample_eval as kernel
    from tsim_tpu_torch.models.exported import cultivation_d3, distillation_d3

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()
    build.load()
    circuit = distillation_d3(p=0.05)
    sampler = circuit.compile_detector_sampler(seed=0, device="cuda")
    sampler.sample(cs.MAIN_BATCH, batch_size=cs.MAIN_BATCH, append_observables=True)  # warm-up
    torch.cuda.synchronize()
    kernel.reset_launch_counts()
    t0 = time.perf_counter()
    out = sampler.sample(cs.MAIN_SHOTS, batch_size=cs.MAIN_BATCH, append_observables=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernel.launch_counts)
    print(f"phase 4: {cs.MAIN_SHOTS / wall:.0f} shots/s, launches {launches}", flush=True)
    cultivation = cultivation_d3(p=0.001, checks=2)
    cs.sharded_phase(circuit, cultivation, cs.reference_fold(cultivation),
                     out.mean(axis=0, dtype=np.float64), launches, cs.MAIN_SHOTS / wall)
    print("phase 23: ok", flush=True)


if __name__ == "__main__":
    main()
