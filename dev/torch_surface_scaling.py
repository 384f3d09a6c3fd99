"""Time the port on the surface-code memory scaling of BASELINE workload 2.

``bench_suite.py::bench_surface_code_scaling``'s configuration: the rotated
surface-code memory at distance d with d rounds, ``PAULI_CHANNEL_1(p, p/2,
p/2)`` after single-qubit Cliffords, ``PAULI_CHANNEL_2`` at p/15 for each of
its 15 Paulis after two-qubit ones and a flip of p before measurements, at
p = 0.002, for d = 5, 7, 9 and 11. For each distance: the host compile
(``compile_detector_sampler(seed=0)``, the AOT cache cleared first, with its
stages), the detector error model (``approximate_disjoint_errors=True``,
which ``PAULI_CHANNEL_2`` needs), and shots/s of ``sample(2**20,
separate_observables=True)`` after one warm-up call, four calls, as
``bench_suite.py::_throughput`` takes them, in call order, each with the
process's CPU time over its wall time (below 1 where the host took the
core away), and the load average before them. A Clifford circuit compiles to a
fully-direct program, which the card's sampler draws on the host with the
C++ Pauli-frame engine (``direct_route`` "native_frame"), so these are host
times: the card's name and power limit and the host's CPU are printed
beside them. A call's time is then split (median of three) into the
engine's frame simulation (``NativeFrameSampler._run``: gates, noise,
detector and observable parities, 64 shots a word) and the unpacking of
its detector and observable words into the (shots, n) bool rows. Prints one
JSON line at the end.

    python3 dev/torch_surface_scaling.py [--distances 5 7 9 11] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

P = 0.002
SHOTS = 1 << 20
REPEATS = 4


def host_cpu() -> str:
    """The host CPU from ``/proc/cpuinfo``: its model name or, where the file
    gives none (or "unknown", as a virtual machine may), the machine type
    with the vendor, family and model numbers (x86) or the implementer and
    part (Arm) that it does give."""
    info = {}
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                key, sep, value = line.partition(":")
                if sep:
                    info.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    if info.get("model name", "unknown") != "unknown":
        return info["model name"]
    keys = ("vendor_id", "cpu family", "model", "CPU implementer", "CPU part")
    found = ", ".join(f"{k} {info[k]}" for k in keys if info.get(k))
    return f"{platform.machine()} ({found or 'no model in /proc/cpuinfo'})"


def card() -> str:
    """``nvidia-smi``'s name and power limit of the card, or why there is none."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except FileNotFoundError:
        return "no nvidia-smi"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else out.stderr.strip()


def measure(d: int, device: str) -> dict:
    from tsim_tpu_torch.compile import aot_cache
    from tsim_tpu_torch.models import rotated_surface_code_memory_z

    circuit = rotated_surface_code_memory_z(
        d, d, pauli_channel_1=(P, P / 2, P / 2), pauli_channel_2=tuple([P / 15] * 15),
        before_measure_flip_probability=P,
    )
    aot_cache.clear_memory()
    t0 = time.perf_counter()
    sampler = circuit.compile_detector_sampler(seed=0, device=device)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dem = circuit.detector_error_model(approximate_disjoint_errors=True)
    dem_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sampler.sample(SHOTS, separate_observables=True)  # warm-up: the frame engine's build and first touch
    first_s = time.perf_counter() - t0
    rates, cpu_shares = [], []
    load = os.getloadavg()
    for _ in range(REPEATS):
        t0, c0 = time.perf_counter(), time.process_time()
        det, _obs = sampler.sample(SHOTS, separate_observables=True)
        wall = time.perf_counter() - t0
        rates.append(SHOTS / wall)
        cpu_shares.append((time.process_time() - c0) / wall)
        if det.shape != (SHOTS, circuit.num_detectors):
            raise RuntimeError(f"d={d}: detector rows of shape {det.shape}")
    ranked = sorted(rates)
    engine = sampler._native_frame_sampler()
    split = {"run_s": [], "unpack_s": []}
    if engine is not None:
        for _ in range(3):
            t0 = time.perf_counter()
            _rec, dets, obs = engine._run(SHOTS)
            t1 = time.perf_counter()
            engine._unpack(dets, engine.num_det, SHOTS, False)
            engine._unpack(obs, engine.num_obs, SHOTS, False)
            split["run_s"].append(t1 - t0)
            split["unpack_s"].append(time.perf_counter() - t1)
    split = {k: sorted(v)[len(v) // 2] for k, v in split.items() if v}
    row = {
        "d": d, "qubits": circuit.num_qubits, "detectors": circuit.num_detectors,
        "route": sampler.direct_route, "compile_s": compile_s, "compile_stats": sampler.compile_stats,
        "dem_s": dem_s, "dem_lines": len(str(dem).splitlines()), "first_call_s": first_s,
        "shots": SHOTS, "shots_per_s": rates, "best_shots_per_s": ranked[-1],
        "median_shots_per_s": ranked[len(ranked) // 2], "split": split,
        "cpu_over_wall": cpu_shares, "loadavg": load,
    }
    print(f"d={d}: {circuit.num_qubits} qubits, {circuit.num_detectors} detectors, route {row['route']}; "
          f"compile {compile_s:.3f} s {sampler.compile_stats}; DEM {dem_s:.3f} s ({row['dem_lines']} lines); "
          f"first call {first_s:.3f} s; shots/s {' '.join(f'{r:.0f}' for r in rates)}; "
          f"CPU/wall time of the calls {' '.join(f'{c:.3f}' for c in cpu_shares)}; load {load}; "
          f"split of a call: {split}", flush=True)
    return row


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--distances", type=int, nargs="+", default=[5, 7, 9, 11])
    parser.add_argument("--device", default="cuda", help="the sampler's device (cuda: the card)")
    args = parser.parse_args()
    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        sys.exit("no CUDA device: run this on the card, or pass --device cpu")
    name = card()
    cpu = host_cpu()
    print(f"{name}; host CPU {cpu}, {os.cpu_count()} cores; torch {torch.__version__}", flush=True)
    rows = [measure(d, args.device) for d in args.distances]
    print(json.dumps({"card": name, "host_cpu": cpu, "cores": os.cpu_count(), "device": args.device,
                      "p": P, "rows": rows}))


if __name__ == "__main__":
    main()
