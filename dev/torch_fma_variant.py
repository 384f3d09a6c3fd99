"""What pinning the f32 complex products to explicit FMAs costs, and buys.

``kernels/csrc/sample_eval.cu`` writes the complex products of the f32
kernels (``cmul`` and the graph sum in ``accumulate_graph``) with
``__fmaf_rn`` and ``__fmul_rn``, so that nvcc cannot contract them into fused
multiply-adds in a different way for each instance: the 32-shot block of
``wide`` must equal the 128-shot block and K3a bit for bit. This script builds
a copy of the sources under ``build/`` with those products written as plain
``a * b - c * d``, left to nvcc's contraction, and times both builds in turns
(pinned, free, free, pinned; one process a build, since a library loads once
per process) at 2^20 + 1 seeded rows: K2 on d3's 6-graph rung and 1-check
cultivation's small rungs, each with its K3b bit-equality, and K1 on d3's
first 103-graph and 2-check cultivation's 307-graph rung, each with the
bit-equality of its two blocks and of each with K3a at 1024 rows.

    python3 dev/torch_fma_variant.py

Needs a CUDA device and ``nvcc``; imports only the port.
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PINNED = (
    ("  const float nre = __fmaf_rn(re, fr, -__fmul_rn(im, fi));\n"
     "  const float nim = __fmaf_rn(re, fi, __fmul_rn(im, fr));",
     "  const float nre = re * fr - im * fi;\n  const float nim = re * fi + im * fr;"),
    ("    acc_re[k] += __fmaf_rn(re[k], pr, -__fmul_rn(im[k], pi));\n"
     "    acc_im[k] += __fmaf_rn(re[k], pi, __fmul_rn(im[k], pr));",
     "    acc_re[k] += re[k] * pr - im[k] * pi;\n    acc_im[k] += re[k] * pi + im[k] * pr;"),
)
RUNGS = [("d3", 2)] + [("cultivation_checks1", i) for i in range(1, 8)] + [("d3", 3), ("cultivation", 9)]


def free_sources(csrc: Path) -> Path:
    """A copy of ``csrc`` whose f32 complex products are left to nvcc."""
    dst = ROOT / "build" / "fma_free"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(csrc, dst)
    path = dst / "sample_eval.cu"
    text = path.read_text()
    for pinned, free in PINNED:
        if text.count(pinned) != 1:
            raise SystemExit(f"sample_eval.cu no longer holds {pinned!r} exactly once")
        text = text.replace(pinned, free)
    path.write_text(text)
    return dst


def time_build(variant: str, reps: int) -> None:
    """Builds the kernels as ``variant`` ("pinned" or "free") and prints their times."""
    import torch

    from dev.torch_kernel_ablate import device_ms, load_rung
    from tsim_tpu_torch.compile.sample_tables import SampleTables
    from tsim_tpu_torch.kernels import build
    from tsim_tpu_torch.kernels import sample_eval as kernel

    if variant == "free":
        build.CSRC = free_sources(build.CSRC)
    rows = (1 << 20) + 1
    for program, rung in RUNGS:
        c = load_rung(program, rung)
        t = SampleTables(c).to("cuda")
        x = np.random.default_rng(rung).integers(0, 2, size=(rows, c.n_params), dtype=np.uint8)
        x = torch.from_numpy(x).cuda()
        config = kernel.layout(c.num_graphs)
        ms = device_ms(lambda: kernel.launch(t, x, config), reps)
        if config == "wide":
            xs = x[:1024]
            a = kernel.launch(t, xs, "wide", _block_shots=32)
            b = kernel.launch(t, xs, "wide", _block_shots=128)
            k3a = kernel.launch(t, xs, "per_term_wide")
            same = (f"instances equal {torch.equal(a, b)}, 128 equals K3a {torch.equal(b, k3a)}, "
                    f"32 equals K3a {torch.equal(a, k3a)}")
        else:
            same = f"equals K3b {torch.equal(kernel.launch(t, x, 'small'), kernel.launch(t, x, 'per_term_small'))}"
        print(f"{variant:6s} {program}[{rung}] G={c.num_graphs} {config}: {ms:.4f} ms; {same}", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--variant", choices=("pinned", "free"), help="time one build only (one process a build)")
    args = parser.parse_args()
    if args.variant:
        time_build(args.variant, args.reps)
        return
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for variant in ("pinned", "free", "free", "pinned"):
        subprocess.run([sys.executable, __file__, "--variant", variant, "--reps", str(args.reps)], check=True)


if __name__ == "__main__":
    main()
