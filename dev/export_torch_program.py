"""Export programs compiled by tsim_tpu, with reference data, for tsim_tpu_torch.

Six programs, each a ``.npz`` under ``tsim_tpu_torch/programs/``:

* ``d3``: ``distillation_d3(p=0.05).compile_detector_sampler(seed=0)``,
  with the per-output means of tsim_tpu's own sampler (detectors then
  observables) at 2^18 shots, as the physics reference;
* ``d3_state_probs``: ``distillation_d3(p=0.05).compile_state_probs(seed=0)``,
  with replay data: 4096 noise rows f from tsim_tpu's channel sampler, 4
  states (the first 4 records of tsim_tpu's ``compile_sampler(seed=0)`` on
  the same circuit) and tsim_tpu's ``_probability_body`` for each;
* ``cultivation``: ``cultivation_d3(p=0.001, checks=2)
  .compile_detector_sampler(seed=0)``, with replay data: 4096 shots of
  tsim_tpu's exact sampling (batch 0 of seed 0), their noise uniforms,
  their per-rung draw uniforms and the resulting output bits; and its
  postselected reference: 2^18 shots sampled with the postselection mask
  over all detectors and both reference samples on, the survivors (rows
  with no detection event) as a fraction of the shots, their per-output
  means (detectors then observables) and the reference sample row;
* ``cultivation_checks1``: ``cultivation_d3(p=0.001, checks=1)
  .compile_detector_sampler(seed=0)``, with the per-output means of
  tsim_tpu's own sampler at 2^20 shots, as the physics reference;
* ``d5``: ``distillation_d5(p=0.02).compile_detector_sampler(seed=0)``,
  with the per-output means of tsim_tpu's own sampler at 2^18 shots;
* ``surface_d7``: the d7 surface-code memory of ``bench_suite.py``'s panel,
  ``rotated_surface_code_memory_z(7, 7)`` at p = 0.001 for its three noise
  channels, ``.compile_detector_sampler(seed=0)``: a fully-direct program,
  with the per-output means of tsim_tpu's C++ frame engine
  (``TSIM_TPU_NATIVE_DIRECT=1``) at 2^18 shots and the sha256 of the text of
  tsim_tpu's ``detector_error_model()`` of the circuit.

The port compiles these circuits itself; each file is the reference its own
compile must equal leaf for leaf, on a machine without JAX too.

Each program is converted with ``tsim_tpu_torch.program_io.from_reference``.
Needs JAX; runs on the CPU, where tsim_tpu evaluates exactly (the two
cultivation programs take about 8 and 2 minutes):

    JAX_PLATFORMS=cpu python dev/export_torch_program.py [--program NAME]
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
POSTSELECTED_SHOTS = 1 << 18
CHECKS1_SHOTS = 1 << 20
REPLAY_ROWS = 4096
REPLAY_STATES = 4
SEED = 0


def compile_d3():
    """The tsim_tpu detector sampler of d3 distillation at p = 0.05, seed 0."""
    from tsim_tpu.models.distillation import distillation_d3

    return distillation_d3(p=0.05).compile_detector_sampler(seed=SEED)


def compile_d3_state_probs():
    """The tsim_tpu state-probability estimator of d3 distillation at p = 0.05, seed 0."""
    from tsim_tpu.models.distillation import distillation_d3

    return distillation_d3(p=0.05).compile_state_probs(seed=SEED)


def compile_d5():
    """The tsim_tpu detector sampler of d5 distillation at p = 0.02, seed 0."""
    from tsim_tpu.models.distillation import distillation_d5

    return distillation_d5(p=0.02).compile_detector_sampler(seed=SEED)


def surface_d7_circuit():
    """bench_suite.py's d7 panel: the rotated d7 surface-code memory (7
    rounds) at p = 0.001 after Cliffords, before measurements and after resets."""
    from tsim_tpu.models.surface_code import rotated_surface_code_memory_z

    return rotated_surface_code_memory_z(
        7, 7, after_clifford_depolarization=0.001, before_measure_flip_probability=0.001,
        after_reset_flip_probability=0.001,
    )


def compile_cultivation(checks: int = 2):
    """The tsim_tpu detector sampler of d3 cultivation at p = 0.001, seed 0."""
    from tsim_tpu.models.cultivation import cultivation_d3

    return cultivation_d3(p=0.001, checks=checks).compile_detector_sampler(seed=SEED)


def export_sampler(sampler):
    """A tsim_tpu sampler's program and noise as a tsim_tpu_torch ExportedProgram."""
    from tsim_tpu_torch.program_io import from_reference

    return from_reference(sampler._program, sampler._channel_sampler, sampler._num_detectors)


def jax_replay(sampler, batch: int, seed: int):
    """tsim_tpu's batch-0 randomness and outputs for ``sampler`` at ``seed``.

    Replays the sampler's key schedule: the per-batch ``fold_in`` of the
    noise and sampling keys (``tsim_tpu/sampler.py:156-157``), the noise
    uniforms, then one ``split`` per rung for the Bernoulli draws
    (``sampler.py:75``; ``bernoulli(key, p)`` is ``uniform(key) < p``).
    Returns (noise uniforms (batch, C) float32, draw uniforms (one (batch,)
    float32 array per rung past the first, component by component), output
    bits (batch, num_outputs) uint8, max norm deviation).
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    import tsim_tpu.sampler as jax_sampler

    program, dc = sampler._program, sampler._device_channels
    base = jax.random.key(seed)
    k_noise, k_sample = jax.random.fold_in(base, 0), jax.random.fold_in(base, 1)
    u_noise = np.asarray(jax.random.uniform(k_noise, (batch, dc.num_channels), dtype=jnp.float32))
    f = dc.sample(k_noise, batch)
    bits, dev = jax_sampler.sample_program_with_deviation(program, f, k_sample)
    draws, key = [], k_sample
    for comp in program.components:
        for _ in comp.compiled_scalar_graphs[1:]:
            key, dk = jax.random.split(key)
            draws.append(np.asarray(jax.random.uniform(dk, (batch,), dtype=jnp.float32)))
    return u_noise, draws, np.asarray(bits), float(np.asarray(dev)[0])


def postselected_reference(sampler, shots: int) -> tuple[dict, dict]:
    """tsim_tpu's postselected sampling with the mask over all detectors and
    both reference samples on: (meta entries, replay arrays) with the
    survivor fraction, the survivors' per-output means and the reference row."""
    import numpy as np

    mask = np.ones(sampler._num_detectors, bool)
    det, obs = sampler.sample(
        shots, batch_size=REFERENCE_BATCH, postselection_mask=mask,
        use_detector_reference_sample=True, use_observable_reference_sample=True,
        separate_observables=True,
    )
    keep = ~(det & mask).any(axis=1)
    survivors = np.hstack([det, obs])[keep]
    meta = {
        "reference": f"sample({shots}, batch_size={REFERENCE_BATCH}, postselection_mask=ones, "
        "use_detector_reference_sample=True, use_observable_reference_sample=True, "
        "separate_observables=True), survivors = rows with no detector set; "
        "tsim_tpu on the CPU (exact evaluation)",
        "reference_shots": shots,
        "reference_survivors": int(keep.sum()),
        "survivor_fraction": float(keep.mean()),
    }
    replay = {
        "survivor_means": survivors.mean(axis=0),
        "reference_sample": sampler._compute_reference_sample().astype(np.uint8),
    }
    return meta, replay


def state_probs_replay(sp, rows: int, n_states: int) -> dict:
    """Noise rows, states and tsim_tpu's ``_probability_body`` values for them."""
    import jax.numpy as jnp
    import numpy as np

    from tsim_tpu.models.distillation import distillation_d3

    states = distillation_d3(p=0.05).compile_sampler(seed=SEED).sample(n_states)
    f = np.asarray(sp._channel_sampler.sample(rows), np.uint8)
    probs = np.stack(
        [np.asarray(sp._probability_body(jnp.asarray(f), s), np.float32) for s in states]
    )
    return {"f": f, "states": np.asarray(states, np.uint8), "probabilities": probs}


def _d3(args):
    sampler = compile_d3()
    exported = export_sampler(sampler)
    t0 = time.perf_counter()
    samples = sampler.sample(args.shots, batch_size=REFERENCE_BATCH, append_observables=True)
    print(f"sampled {args.shots} shots in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return dataclasses.replace(
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


def _d3_state_probs(args):
    sp = compile_d3_state_probs()
    t0 = time.perf_counter()
    replay = state_probs_replay(sp, REPLAY_ROWS, REPLAY_STATES)
    print(f"state-probability replay in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return dataclasses.replace(
        export_sampler(sp),
        meta={
            "circuit": "tsim_tpu.models.distillation.distillation_d3(p=0.05)",
            "compile": f"compile_state_probs(seed={SEED})",
            "replay": "f: channel_sampler.sample(4096) of the estimator; states: "
            f"compile_sampler(seed={SEED}).sample(4); probabilities[i]: "
            "_probability_body(f, states[i]), tsim_tpu on the CPU (exact evaluation)",
        },
        replay=replay,
    )


def _cultivation(args):
    import numpy as np

    sampler = compile_cultivation()
    exported = export_sampler(sampler)
    t0 = time.perf_counter()
    u_noise, draws, bits, dev = jax_replay(sampler, REPLAY_ROWS, SEED)
    print(f"cultivation replay in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    t0 = time.perf_counter()
    post_meta, post_replay = postselected_reference(sampler, POSTSELECTED_SHOTS)
    print(f"postselected reference in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return dataclasses.replace(
        exported,
        meta={
            "circuit": "tsim_tpu.models.cultivation.cultivation_d3(p=0.001, checks=2)",
            "compile": f"compile_detector_sampler(seed={SEED})",
            "replay": f"batch 0 of seed {SEED} at batch size 4096 (dev/export_torch_program.py::"
            "jax_replay), tsim_tpu on the CPU (exact evaluation)",
            "replay_norm_deviation": dev,
            **post_meta,
        },
        replay={
            "noise_uniforms": u_noise,
            "draw_uniforms": np.stack(draws),
            "bits": bits.astype(np.uint8),
            **post_replay,
        },
    )


def _cultivation_checks1(args):
    sampler = compile_cultivation(checks=1)
    exported = export_sampler(sampler)
    t0 = time.perf_counter()
    samples = sampler.sample(CHECKS1_SHOTS, batch_size=REFERENCE_BATCH, append_observables=True)
    print(f"sampled {CHECKS1_SHOTS} shots in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return dataclasses.replace(
        exported,
        reference_means=samples.mean(axis=0),
        meta={
            "circuit": "tsim_tpu.models.cultivation.cultivation_d3(p=0.001, checks=1)",
            "compile": f"compile_detector_sampler(seed={SEED})",
            "reference": "sample(shots, batch_size=65536, append_observables=True), "
            "tsim_tpu on the CPU (exact evaluation)",
            "reference_shots": CHECKS1_SHOTS,
        },
    )


def _d5(args):
    sampler = compile_d5()
    exported = export_sampler(sampler)
    t0 = time.perf_counter()
    samples = sampler.sample(REFERENCE_SHOTS, batch_size=REFERENCE_BATCH, append_observables=True)
    print(f"sampled {REFERENCE_SHOTS} shots in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return dataclasses.replace(
        exported,
        reference_means=samples.mean(axis=0),
        meta={
            "circuit": "tsim_tpu.models.distillation.distillation_d5(p=0.02)",
            "compile": f"compile_detector_sampler(seed={SEED})",
            "reference": "sample(shots, batch_size=65536, append_observables=True), "
            "tsim_tpu on the CPU (exact evaluation)",
            "reference_shots": REFERENCE_SHOTS,
        },
    )


def _surface_d7(args):
    import hashlib

    circuit = surface_d7_circuit()
    previous = os.environ.get("TSIM_TPU_NATIVE_DIRECT")
    os.environ["TSIM_TPU_NATIVE_DIRECT"] = "1"  # tsim_tpu's route on an accelerator
    try:
        sampler = circuit.compile_detector_sampler(seed=SEED)
        if sampler._program.components or sampler._native_frame_sampler() is None:
            raise RuntimeError("the d7 surface code did not take the native frame route")
        t0 = time.perf_counter()
        samples = sampler.sample(REFERENCE_SHOTS, append_observables=True)
        print(f"sampled {REFERENCE_SHOTS} shots in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    finally:
        if previous is None:
            del os.environ["TSIM_TPU_NATIVE_DIRECT"]
        else:
            os.environ["TSIM_TPU_NATIVE_DIRECT"] = previous
    t0 = time.perf_counter()
    dem = str(circuit.detector_error_model())
    print(f"detector error model in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return dataclasses.replace(
        export_sampler(sampler),
        reference_means=samples.mean(axis=0),
        meta={
            "circuit": "tsim_tpu.models.surface_code.rotated_surface_code_memory_z(7, 7, "
            "after_clifford_depolarization=0.001, before_measure_flip_probability=0.001, "
            "after_reset_flip_probability=0.001)",
            "compile": f"compile_detector_sampler(seed={SEED})",
            "reference": "sample(shots, append_observables=True) with TSIM_TPU_NATIVE_DIRECT=1 "
            "(tsim_tpu's C++ Pauli-frame engine)",
            "reference_shots": REFERENCE_SHOTS,
            "dem_sha256": hashlib.sha256(dem.encode()).hexdigest(),
            "dem_lines": len(dem.splitlines()),
        },
    )


PROGRAMS = {
    "d3": _d3,
    "d3_state_probs": _d3_state_probs,
    "cultivation": _cultivation,
    "cultivation_checks1": _cultivation_checks1,
    "d5": _d5,
    "surface_d7": _surface_d7,
}


def main() -> None:
    from tsim_tpu_torch.models.exported import (
        CULTIVATION_CHECKS1_PROGRAM,
        CULTIVATION_PROGRAM,
        D3_PROGRAM,
        D3_STATE_PROBS_PROGRAM,
        D5_PROGRAM,
        SURFACE_D7_PROGRAM,
    )
    from tsim_tpu_torch.program_io import save_npz

    paths = {
        "d3": D3_PROGRAM,
        "d3_state_probs": D3_STATE_PROBS_PROGRAM,
        "cultivation": CULTIVATION_PROGRAM,
        "cultivation_checks1": CULTIVATION_CHECKS1_PROGRAM,
        "d5": D5_PROGRAM,
        "surface_d7": SURFACE_D7_PROGRAM,
    }
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--program", choices=[*PROGRAMS, "all"], default="all")
    parser.add_argument("--shots", type=int, default=REFERENCE_SHOTS, help="d3 reference shots")
    args = parser.parse_args()
    for name in PROGRAMS if args.program == "all" else [args.program]:
        t0 = time.perf_counter()
        exported = PROGRAMS[name](args)
        save_npz(paths[name], exported)
        print(
            f"wrote {paths[name]} ({os.path.getsize(paths[name])} bytes) "
            f"in {time.perf_counter() - t0:.1f} s",
            file=sys.stderr,
        )


if __name__ == "__main__":
    main()
