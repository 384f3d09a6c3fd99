"""Split the wide f32 sampling kernel's time by stage on a CUDA card, or that
of the wide approximate exact kernel (``--kernel approx``).

The port of ``dev/kernel_ablate.py``: it launches the wide kernel of
``tsim_tpu_torch/kernels/csrc/sample_eval.cu`` (K1) with some of its stages
switched off at compile time (``tsim_sample_eval_ablate``) and times each
variant with CUDA events. Variants, named as in ``dev/kernel_ablate.py``:

    empty        prefactor and graph sum only
    par1         node-phase parities, consumed without their factors
    par-all      the parities of all four families, without factors
    par1+T1      node phases in full
    par+T1..T3   node phases, half-pi phases and pi products in full
    full         every stage: K1's own code

Oracles: ``full`` equals K1 bit for bit; ``empty``, ``par1+T1`` and
``par+T1..T3`` equal the plain version on the rung's tables with the other
families emptied, within rtol 1e-5 of the row's mass (the sum over graphs
of |product|, ``sample_product_sum_reference``); ``par1`` and
``par-all`` are for timing only and must be finite.

    python3 dev/torch_kernel_ablate.py [--program cultivation] [--rung 9]
                                       [--rows-log2 20] [--reps 10]
    python3 dev/torch_kernel_ablate.py --kernel approx [--program d3_state_probs] [--rung 1]

The default is the 307-graph rung of 2-check cultivation at 2^20 rows.

``--kernel approx`` splits ``approx_wide`` (K6, ``kernels/csrc/exact_eval.cu``,
``tsim_approx_eval_ablate``) on a rung with approximate floatfactors, by
default the 172-graph joint rung of d3's state probabilities: ``empty`` (the
prefactor and the graph sum), ``par-all`` (with the integer stage, its
parities consumed without factors), ``full`` (K6's own code, equal to K6 bit
for bit). ``par-all`` less ``empty`` is the integer stage, ``full`` less
``par-all`` the per-shot stage.

The timers (``time_ms``, ``device_ms``) and ``state_prob_path_rows`` also
serve ``chip_smoke.py`` and ``dev/torch_time_rungs.py``.

Needs a CUDA device; imports only the port.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RTOL, ATOL = 1e-5, 1e-8
PROGRAMS = ("cultivation", "cultivation_checks1", "d3", "d3_state_probs")
SLEEP_CYCLES = 50_000_000  # about 25 ms of the card's clock, longer than the queued calls take to enqueue


def load_rung(program: str, rung: int):
    """Rung ``rung`` of the first component of a committed program."""
    from tsim_tpu_torch.models.exported import cultivation_d3, distillation_d3

    exported = {
        "cultivation": lambda: cultivation_d3(p=0.001, checks=2).load(),
        "cultivation_checks1": lambda: cultivation_d3(p=0.001, checks=1).load(),
        "d3": lambda: distillation_d3(p=0.05).load(),
        "d3_state_probs": lambda: distillation_d3(p=0.05).load_state_probs(),
    }[program]()
    return exported.program.components[0].compiled_scalar_graphs[rung]


def emptied(circuit, keep):
    """``circuit`` with the term families not in ``keep`` (1 to 4) emptied."""
    from tsim_tpu_torch.program_io import HalfPiPhases, NodePhases, PhasePairs, PiProducts

    G, P = circuit.num_graphs, circuit.n_params
    t2, t3 = np.zeros((0, G), np.int32), np.zeros((0, G, P), np.uint8)
    counts = np.zeros(G, np.int32)
    empty = {
        1: ("node_phases", NodePhases(phases=t2, params=t3, counts=counts)),
        2: ("halfpi_phases", HalfPiPhases(coeffs=t2, params=t3)),
        3: ("pi_products", PiProducts(psi_const=t2, psi_params=t3, phi_const=t2, phi_params=t3)),
        4: ("phase_pairs", PhasePairs(alpha=t2, alpha_params=t3, beta=t2, beta_params=t3, counts=counts)),
    }
    return dataclasses.replace(circuit, **dict(v for k, v in empty.items() if k not in keep))


def time_ms(fn, reps: int = 5) -> float:
    """Mean milliseconds per call, with CUDA events, after one warm-up call."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 5) -> float:
    """Mean device milliseconds of one call, after one warm-up call: each
    call between its own pair of CUDA events, all queued behind a sleep on
    the card, so the host's launch time stays outside the pairs."""
    import torch

    fn()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in pairs) / reps


def state_prob_path_rows(circuit, count: int):
    """(joint rung's exact tables, ``count`` rows) as the state-probability
    path of ``circuit`` evaluates them on the card: f-bits drawn by its own
    noise sampler (seed 0), the first exported state tiled behind them."""
    import torch

    from tsim_tpu_torch.sampler import static_take_columns

    sp = circuit.compile_state_probs(seed=0, device="cuda")
    comp = sp._tables.components[0]
    state = torch.as_tensor(np.asarray(circuit.load_state_probs().replay["states"][0], np.uint8), device="cuda")
    f = sp._device_channels.sample(sp._generator, count)
    x = torch.cat([static_take_columns(f, comp.f_selection),
                   state[comp.output_indices].expand(count, -1)], dim=1).contiguous()
    return comp.rungs[1], x


def ablate_rung(circuit, x, reps: int = 10) -> list[dict]:
    """Every variant on the rung ``circuit`` and the CUDA rows ``x``: one dict
    per variant with its name, mean ms, oracle, error against the oracle
    (relative to the row's mass, and absolute) and whether it passed."""
    import torch

    from tsim_tpu_torch.compile.sample_eval import sample_product_sum_reference
    from tsim_tpu_torch.compile.sample_tables import SampleTables
    from tsim_tpu_torch.kernels import sample_eval as kernel

    tables = SampleTables(circuit).to(x.device)
    k1 = kernel.launch(tables, x, "wide", _block_shots=128)  # the ablation's own block
    results = []
    for name, parities, factors in kernel.ABLATION_VARIANTS:
        got = kernel.ablate(tables, x, name)
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(got).all())
        err = abs_err = None
        if name == "full":
            oracle, ok = "K1 bit for bit", torch.equal(got, k1)
            err = abs_err = float((got - k1).abs().max())
        elif set(parities) == set(factors):
            want, mass = sample_product_sum_reference(
                SampleTables(emptied(circuit, factors)).to(x.device), x, with_mass=True
            )
            scale = mass[:, None]
            diff = (got - want).abs()
            err, abs_err = float((diff / scale.clamp_min(1e-30)).max()), float(diff.max())
            oracle, ok = f"plain, families {factors} only", bool((diff <= ATOL + RTOL * scale).all())
            del want, mass, scale, diff
        else:
            oracle, ok = "finite (timing only)", True
        ms = time_ms(lambda n=name: kernel.ablate(tables, x, n), reps)
        results.append({
            "name": name, "ms": ms, "oracle": oracle, "err": err, "abs_err": abs_err,
            "ok": ok and finite,
        })
        del got
    return results


def ablate_approx_rung(circuit, x, reps: int = 10) -> list[dict]:
    """Every variant of K6's stage split on the approximate rung ``circuit``
    and the CUDA rows ``x``: dicts as :func:`ablate_rung` gives them."""
    import torch

    from tsim_tpu_torch.compile.exact_tables import ExactTables
    from tsim_tpu_torch.kernels import exact_eval as kernel

    tables = ExactTables(circuit).to(x.device)
    k6 = kernel.approx_partials(tables, x)
    results = []
    for name in kernel.APPROX_ABLATION_VARIANTS:
        got = kernel.ablate_approx(tables, x, name)
        torch.cuda.synchronize()
        ok, err = bool(torch.isfinite(got).all()), None
        oracle = "finite (timing only)"
        if name == "full":
            oracle, ok = "K6 bit for bit", ok and torch.equal(got, k6)
            err = float((got - k6).abs().max())
        ms = time_ms(lambda n=name: kernel.ablate_approx(tables, x, n), reps)
        results.append({"name": name, "ms": ms, "oracle": oracle, "err": err, "abs_err": err, "ok": ok})
        del got
    return results


def main() -> None:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernel", choices=("f32", "approx"), default="f32")
    parser.add_argument("--program", choices=PROGRAMS)
    parser.add_argument("--rung", type=int)
    parser.add_argument("--rows-log2", type=int, default=20)
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA device", flush=True)
        sys.exit(1)
    program = args.program or ("cultivation" if args.kernel == "f32" else "d3_state_probs")
    rung = args.rung if args.rung is not None else (9 if args.kernel == "f32" else 1)
    circuit = load_rung(program, rung)
    rows = 1 << args.rows_log2
    x = np.random.default_rng(0).integers(0, 2, size=(rows, circuit.n_params), dtype=np.uint8)
    x = torch.from_numpy(x).to("cuda")
    print(f"{program} rung {rung} ({args.kernel}): G={circuit.num_graphs} P={circuit.n_params}, "
          f"{rows} rows, {torch.cuda.get_device_name(0)}", flush=True)
    results = (ablate_rung if args.kernel == "f32" else ablate_approx_rung)(circuit, x, args.reps)
    for r in results:
        err = "" if r["err"] is None else f", err {r['err']:.3e}"
        print(f"{r['name']:12s} {r['ms']:9.4f} ms  [{r['oracle']}{err}] -> {'ok' if r['ok'] else 'FAIL'}")
    print(json.dumps({"kernel": args.kernel, "program": program, "rung": rung, "rows": rows,
                      "variants": results}))
    if not all(r["ok"] for r in results):
        sys.exit(1)


if __name__ == "__main__":
    main()
