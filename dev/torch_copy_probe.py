"""Time the two ways of moving sampled bits from a CUDA card into the host
array that ``sample()`` returns (tsim_tpu_torch).

    python3 dev/torch_copy_probe.py [--batches 48] [--batch 1048576] [--outputs 20]

``--batches`` batches of (``--batch``, ``--outputs``) 0/1 uint8 bits, made on
the card once, go to the host:

1. staging (the sampler's way, ``sampler._RowsToHost``): a pageable
   ``np.empty`` result; each batch copied on a stream of its own into one of
   two pinned staging buffers and moved into the result's rows by the host;
2. pinned result: the result itself pinned (``torch.empty(...,
   pin_memory=True)``, its allocation timed apart) and each batch copied
   straight into its rows on a stream of its own.

Wall clock from the first copy's enqueue to the last batch in the result,
with no device work between the copies, so that it times the copies and the
host alone; two rounds in turns (1, 2, 2, 1). D3 distillation's 48 batches of
2^20 shots and 20 outputs are the default.

Then both inside d3 distillation's f32 sampling, where the device works on
the next batch while the host moves the last: ``sample(48 * 2^20,
batch_size=2^20, append_observables=True)`` (1) against the same batches
(``_sample_batch``) copied straight into a pinned result (2), equal bit for
bit on the same seed, in turns (1, 2, 2, 1). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def staging(batches, shape) -> tuple[float, float]:
    """(setup s, copy s) of the sampler's staging path."""
    import torch

    from tsim_tpu_torch.sampler import _RowsToHost

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = np.empty(shape, dtype=np.bool_)
    to_host = _RowsToHost(result, torch.device("cuda"), batches[0].shape[0])
    t1 = time.perf_counter()
    start = 0
    for bits in batches:
        to_host.push(bits, start)
        start += bits.shape[0]
    to_host.close()
    t2 = time.perf_counter()
    assert result[:, 0].sum() == sum(int(b[:, 0].sum()) for b in batches)
    return t1 - t0, t2 - t1


def pinned_result(batches, shape) -> tuple[float, float]:
    """(allocation s, copy s) with the result itself pinned. The pinned
    allocator's cache is emptied first: a result handed to the caller is not
    returned to it, so each call pins anew."""
    import torch

    empty = getattr(torch._C, "_host_emptyCache", None) or getattr(torch._C, "_accelerator_emptyHostCache")
    torch.cuda.synchronize()
    empty()
    t0 = time.perf_counter()
    result = torch.empty(shape, dtype=torch.bool, pin_memory=True)
    t1 = time.perf_counter()
    stream = torch.cuda.Stream()
    ready = torch.cuda.Event()
    ready.record()
    stream.wait_event(ready)
    start = 0
    with torch.cuda.stream(stream):
        for bits in batches:
            result[start : start + bits.shape[0]].copy_(bits.view(torch.bool), non_blocking=True)
            start += bits.shape[0]
    stream.synchronize()
    out = result.numpy()
    t2 = time.perf_counter()
    assert out[:, 0].sum() == sum(int(b[:, 0].sum()) for b in batches)
    return t1 - t0, t2 - t1


def pinned_sample(sampler, shots: int, batch: int) -> np.ndarray:
    """``sampler.sample(shots, batch_size=batch, append_observables=True)``
    with each batch copied straight into a pinned result."""
    import torch

    empty = getattr(torch._C, "_host_emptyCache", None) or getattr(torch._C, "_accelerator_emptyHostCache")
    empty()
    result = torch.empty((shots, sampler._program.num_outputs), dtype=torch.bool, pin_memory=True)
    stream, held = torch.cuda.Stream(), []
    for start in range(0, shots, batch):
        out, _ = sampler._sample_batch(min(batch, shots - start))
        ready = torch.cuda.Event()
        ready.record()
        stream.wait_event(ready)
        with torch.cuda.stream(stream):
            result[start : start + out.shape[0]].copy_(out.view(torch.bool), non_blocking=True)
        held.append(out)
    stream.synchronize()
    return result.numpy()


def sampling(batches: int, batch: int) -> None:
    """Both ways inside d3 distillation's f32 sampling, in turns."""
    import torch

    from tsim_tpu_torch.models.exported import distillation_d3

    shots = batches * batch
    circuit = distillation_d3(p=0.05)
    circuit.compile_detector_sampler(seed=0, device="cuda").sample(batch, batch_size=batch)  # warm-up
    walls = {"staging": [], "pinned result": []}
    outs = {}
    for name in ("staging", "pinned result", "pinned result", "staging"):
        sampler = circuit.compile_detector_sampler(seed=3, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "staging":
            out = sampler.sample(shots, batch_size=batch, append_observables=True)
        else:
            out = pinned_sample(sampler, shots, batch)
        torch.cuda.synchronize()
        walls[name].append(time.perf_counter() - t0)
        outs.setdefault(name, out)
        del out
    same = bool(np.array_equal(outs["staging"], outs["pinned result"]))
    for name, w in walls.items():
        print(f"d3 f32 sampling, {name:14s}: {shots} shots in " + " / ".join(f"{t * 1e3:.1f}" for t in w)
              + " ms = " + " / ".join(f"{shots / t:.0f}" for t in w) + " shots/s")
    print(f"d3 f32 sampling: the two results equal bit for bit: {same}")
    if not same:
        sys.exit("FAIL: the two ways gave different bits")


def main() -> None:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batches", type=int, default=48)
    parser.add_argument("--batch", type=int, default=1 << 20)
    parser.add_argument("--outputs", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip())
    generator = torch.Generator(device="cuda").manual_seed(0)
    batches = [torch.randint(0, 2, (args.batch, args.outputs), dtype=torch.uint8, device="cuda", generator=generator)
               for _ in range(args.batches)]
    shape = (args.batches * args.batch, args.outputs)
    staging(batches[:2], (2 * args.batch, args.outputs))  # warm-up: the pinned allocator, the stream
    rounds = {"staging": [], "pinned result": []}
    for name in ("staging", "pinned result", "pinned result", "staging"):
        fn = staging if name == "staging" else pinned_result
        rounds[name].append(fn(batches, shape))
    mb = shape[0] * shape[1] / 1e6
    for name, runs in rounds.items():
        setup = " / ".join(f"{a * 1e3:.1f}" for a, _ in runs)
        copy = " / ".join(f"{b * 1e3:.1f}" for _, b in runs)
        print(f"{name:14s}: {args.batches} batches of {args.batch} x {args.outputs} ({mb:.0f} MB): "
              f"setup {setup} ms, copies and moves {copy} ms "
              f"({mb / 1e3 / min(b for _, b in runs):.2f} GB/s at best)")
    del batches
    sampling(args.batches, args.batch)


if __name__ == "__main__":
    main()
