"""Which set-bit walk suits the bit-sliced parity stage: lists or ``__ffs``.

The wide kernels form a parity word as the XOR of the bit planes of a mask's
set parameters (``tsim_tpu_torch/kernels/csrc/bitsliced.cuh``). The committed
kernels walk host-built lists of the set parameters, padded to the same
shape for every graph of a rung (``compile/bit_lists.py``). The alternative
needs no lists: read the packed mask words already in the tables and peel
their set bits with ``__ffs``, at the price of trip counts that differ
between the lanes of a warp. This script builds a copy of the CUDA sources
under ``build/`` in which the wide f32 kernel's integer stage walks with
``__ffs`` and times both builds, in turns, on three rungs at 2^20 rows:
K1 (``full``) and the parity stage alone (the ablation's ``par1`` and
``par-all``); each build's K1 must equal the per-term kernel K3a, whose
popcount parities neither walk touches, bit for bit.

    python3 dev/torch_walk_variant.py [--rows-log2 20] [--reps 5]

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

ANCHOR = "\n// Wide configuration (K1;"
CALL = "bitsliced::integer_stage<M, IB>(tb.lists, c0 + tid, bs_dyn, base, columns + tid, stride);"
FFS_CALL = "integer_stage_ffs<M>(tb, c0 + tid, bs_dyn, columns + tid, stride);"
FFS_STAGE = r'''
// Variant: walk the set bits of the packed mask words with __ffs.
template <int NG>
__device__ __forceinline__ bitsliced::Entry<NG> ffs_word(const uint32_t* w_src, int W,
                                                         const bitsliced::Entry<NG>* planes) {
  bitsliced::Entry<NG> acc{};
  for (int i = 0; i < W; ++i) {
    uint32_t m = __ldg(w_src + i);
    while (m) {
      const int p = __ffs(m) - 1;
      m &= m - 1;
      bitsliced::entry_xor(acc, planes[32 * i + p]);
    }
  }
  return acc;
}

template <unsigned M, int NG>
__device__ __forceinline__ void integer_stage_ffs(const Tables& tb, int g,
                                                  const bitsliced::Entry<NG>* planes,
                                                  bitsliced::Entry<NG>* col, int stride) {
  using Entry = bitsliced::Entry<NG>;
  using bitsliced::entry_xor;
  Entry tot[3] = {}, sgn{}, bare{};
  const int W = tb.W;
  auto mask = [&](const uint32_t* words, int t) { return words + (long long)(t * tb.G + g) * W; };
  if (M & kP1) {
    for (int t = 0; t < tb.T1; ++t) {
      const Entry w = ffs_word(mask(tb.np_w, t), W, planes);
      if (M & kT1) col[t * stride] = w; else entry_xor(bare, w);
    }
  }
  if (M & kP2) {
    for (int t = 0; t < tb.T2; ++t) {
      const int coeff = __ldg(tb.hp_c + t * tb.G + g) & 7;
      const Entry w = ffs_word(mask(tb.hp_w, t), W, planes);
      if (M & kT2) bitsliced::ripple_add(tot, w, coeff); else entry_xor(bare, w);
    }
  }
  if (M & kP3) {
    for (int t = 0; t < tb.T3; ++t) {
      const int i = t * tb.G + g;
      const uint32_t pc = 0u - (uint32_t)(__ldg(tb.psi_c + i) & 1);
      const uint32_t qc = 0u - (uint32_t)(__ldg(tb.phi_c + i) & 1);
      const Entry p = ffs_word(mask(tb.psi_w, t), W, planes);
      const Entry q = ffs_word(mask(tb.phi_w, t), W, planes);
#pragma unroll
      for (int k = 0; k < NG; ++k) {
        if (M & kT3) sgn.w[k] ^= (p.w[k] ^ pc) & (q.w[k] ^ qc);
        else bare.w[k] ^= p.w[k] ^ q.w[k];
      }
    }
  }
  if (M & kP4) {
    for (int t = 0; t < tb.T4; ++t) {
      const Entry a = ffs_word(mask(tb.a_w, t), W, planes);
      const Entry b = ffs_word(mask(tb.b_w, t), W, planes);
      if (M & kT4) {
        col[(tb.T1 + 2 * t) * stride] = a;
        col[(tb.T1 + 2 * t + 1) * stride] = b;
      } else {
        entry_xor(bare, a);
        entry_xor(bare, b);
      }
    }
  }
  Entry* sliced = col + (tb.T1 + 2 * tb.T4) * stride;
  sliced[0] = tot[0];
  sliced[stride] = tot[1];
  sliced[2 * stride] = tot[2];
  sliced[3 * stride] = sgn;
  sliced[4 * stride] = bare;
}

// Wide configuration (K1;'''


def patched_sources(csrc: Path) -> Path:
    """A copy of ``csrc`` whose wide f32 kernel walks with ``__ffs``."""
    dst = ROOT / "build" / "walk_variant_ffs"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(csrc, dst)
    path = dst / "sample_eval.cu"
    text = path.read_text()
    for old in (ANCHOR, CALL):
        if text.count(old) != 1:
            raise SystemExit(f"sample_eval.cu no longer holds {old!r} exactly once")
    path.write_text(text.replace(ANCHOR, FFS_STAGE).replace(CALL, FFS_CALL))
    return dst


def time_walk(walk: str, rows_log2: int, reps: int) -> None:
    """Builds the kernels with ``walk`` ("lists" or "ffs") and prints their times."""
    import torch

    from dev.torch_kernel_ablate import load_rung, time_ms
    from tsim_tpu_torch.compile.sample_tables import SampleTables
    from tsim_tpu_torch.kernels import build
    from tsim_tpu_torch.kernels import sample_eval as kernel

    if walk == "ffs":
        build.CSRC = patched_sources(build.CSRC)
    dev = torch.device("cuda")
    for program, rung in (("cultivation", 9), ("cultivation_checks1", 8), ("d3", 3)):
        c = load_rung(program, rung)
        x = np.random.default_rng(0).integers(0, 2, size=(1 << rows_log2, c.n_params), dtype=np.uint8)
        x = torch.from_numpy(x).to(dev)
        t = SampleTables(c).to(dev)
        same = torch.equal(kernel.launch(t, x, "wide"), kernel.launch(t, x, "per_term_wide"))
        times = {
            "full": time_ms(lambda: kernel.launch(t, x, "wide"), reps),
            "par1": time_ms(lambda: kernel.ablate(t, x, "par1"), reps),
            "par-all": time_ms(lambda: kernel.ablate(t, x, "par-all"), reps),
        }
        print(f"{walk:5s} {program} rung {rung} G={c.num_graphs} P={c.n_params}: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
              + f"; K1 equals K3a bit for bit: {same}", flush=True)
        if not same:
            raise SystemExit(f"{walk}: K1 differs from K3a on {program} rung {rung}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows-log2", type=int, default=20)
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--walk", choices=("lists", "ffs"), help="time one build only (one process a build)")
    args = parser.parse_args()
    if args.walk:
        time_walk(args.walk, args.rows_log2, args.reps)
        return
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for walk in ("lists", "ffs", "ffs", "lists"):  # a process each: a library loads once
        subprocess.run([sys.executable, __file__, "--walk", walk, "--rows-log2", str(args.rows_log2),
                        "--reps", str(args.reps)], check=True)


if __name__ == "__main__":
    main()
