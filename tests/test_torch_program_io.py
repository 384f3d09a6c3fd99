"""Program conversion and ``.npz`` I/O of the port, and the committed programs.

Each committed program (``distillation_d3_p0.05.npz``,
``distillation_d3_p0.05_state_probs.npz``,
``cultivation_d3_p0.001_checks1.npz``, ``cultivation_d3_p0.001_checks2.npz``)
must equal, array for array, a fresh export from tsim_tpu, apart from the
reference data that tsim_tpu sampled once; and the port must load and run
them in a process where importing JAX fails.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import tsim_tpu
from dev.export_torch_program import (
    CHECKS1_SHOTS,
    POSTSELECTED_SHOTS,
    REPLAY_ROWS,
    compile_cultivation,
    compile_d3,
    compile_d3_state_probs,
    export_sampler,
)
from tsim_tpu_torch import program_io
from tsim_tpu_torch.models.exported import (
    CULTIVATION_CHECKS1_PROGRAM,
    CULTIVATION_PROGRAM,
    D3_PROGRAM,
    D3_STATE_PROBS_PROGRAM,
)

REPO = Path(__file__).resolve().parents[1]

_CIRCUITS = [
    "H 0\nT 0\nX_ERROR(0.2) 0\nH 0\nM 0",
    "H 0\nH 1\nT 0\nT 1\nCNOT 0 1\nDEPOLARIZE1(0.3) 0 1\n"
    "H 1\nM 0 1\nDETECTOR rec[-1] rec[-2]",
    "H 0\nH 1\nCZ 0 1\nT 0\nX_ERROR(0.25) 1\nH 0 1\nM 0 1",
    "H 0\nS 0\nT 0\nCX 0 1\nT 1\nY_ERROR(0.1) 0\nH 0\nM 0 1",
]


def _assert_same(a: program_io.ExportedProgram, b: program_io.ExportedProgram, skip=()):
    arrays_a, header_a = program_io.flatten(a)
    arrays_b, header_b = program_io.flatten(b)
    for key in skip:
        arrays_a.pop(key, None), arrays_b.pop(key, None), header_a.pop(key, None), header_b.pop(key, None)
    assert sorted(arrays_a) == sorted(arrays_b)
    for key, arr in arrays_a.items():
        assert arr.dtype == arrays_b[key].dtype, key
        np.testing.assert_array_equal(arr, arrays_b[key], err_msg=key)
    assert header_a == header_b


def _check_reference_fields(exported, sampler):
    prog, ref = exported.program, sampler._program
    assert exported.num_detectors == sampler._num_detectors
    assert len(prog.components) == len(ref.components)
    for comp, ref_comp in zip(prog.components, ref.components):
        assert comp.output_indices == tuple(ref_comp.output_indices)
        for csg, ref_csg in zip(comp.compiled_scalar_graphs, ref_comp.compiled_scalar_graphs):
            assert (csg.num_graphs, csg.n_params) == (ref_csg.num_graphs, ref_csg.n_params)
            np.testing.assert_array_equal(csg.phase_pairs.beta_params, ref_csg.phase_pairs.beta_params)
            np.testing.assert_array_equal(
                csg.prefactor.approximate_floatfactors, ref_csg.prefactor.approximate_floatfactors
            )
    assert len(exported.noise.channels) == len(sampler._channel_sampler.channels)
    np.testing.assert_array_equal(
        exported.noise.signature_matrix, sampler._channel_sampler.signature_matrix
    )


@pytest.mark.parametrize("text", _CIRCUITS)
@pytest.mark.parametrize("detectors", [False, True])
def test_round_trip_small_circuits(text, detectors, tmp_path):
    circuit = tsim_tpu.Circuit(text)
    sampler = (
        circuit.compile_detector_sampler(seed=0) if detectors else circuit.compile_sampler(seed=0)
    )
    exported = export_sampler(sampler)
    _check_reference_fields(exported, sampler)
    path = tmp_path / "program.npz"
    program_io.save_npz(path, exported)
    _assert_same(program_io.load_npz(path), exported)


@pytest.fixture(scope="module")
def d3_sampler():
    return compile_d3()


def test_round_trip_d3(d3_sampler, tmp_path):
    exported = export_sampler(d3_sampler)
    _check_reference_fields(exported, d3_sampler)
    path = tmp_path / "d3.npz"
    program_io.save_npz(path, exported)
    _assert_same(program_io.load_npz(path), exported)


def test_committed_d3_equals_fresh_export(d3_sampler):
    committed = program_io.load_npz(D3_PROGRAM)
    # The reference means are sampled once by dev/export_torch_program.py and
    # checked on the card by chip_smoke.py; everything else is compiled.
    _assert_same(committed, export_sampler(d3_sampler), skip=("reference_means", "meta"))
    means = committed.reference_means
    assert means.shape == (20,) and ((means > 0) & (means < 1)).all()
    assert committed.meta["reference_shots"] == 1 << 18
    assert committed.num_detectors == 15 and committed.program.num_outputs == 20
    rungs = committed.program.components[0].compiled_scalar_graphs
    assert [c.num_graphs for c in rungs] == [1, 5, 6, 103, 60, 103]
    assert [c.n_params for c in rungs] == [6, 7, 8, 9, 10, 11]


@pytest.mark.parametrize("path", [D3_STATE_PROBS_PROGRAM, CULTIVATION_PROGRAM], ids=lambda p: p.stem)
def test_round_trip_committed_replays(path, tmp_path):
    """The committed programs with replay data survive save and load."""
    committed = program_io.load_npz(path)
    assert committed.replay and committed.meta["replay"]
    copy = tmp_path / path.name
    program_io.save_npz(copy, committed)
    _assert_same(program_io.load_npz(copy), committed)


def _replay_skip(exported):
    return ("meta", *(f"replay.{k}" for k in exported.replay))


def test_committed_state_probs_equals_fresh_export():
    committed = program_io.load_npz(D3_STATE_PROBS_PROGRAM)
    _assert_same(committed, export_sampler(compile_d3_state_probs()), skip=_replay_skip(committed))
    prog = committed.program
    assert prog.num_outputs == 35 and len(prog.direct_f_indices) == 0
    rungs = prog.components[0].compiled_scalar_graphs
    assert [(c.num_graphs, c.n_params) for c in rungs] == [(1, 21), (172, 56)]
    r = committed.replay
    assert r["f"].shape == (REPLAY_ROWS, 21) and r["states"].shape == (4, 35)
    probs = r["probabilities"]
    assert probs.shape == (4, REPLAY_ROWS) and ((probs >= 0) & (probs <= 1)).all()
    assert (probs > 0).any(axis=1).all()


def test_committed_cultivation_equals_fresh_export():
    committed = program_io.load_npz(CULTIVATION_PROGRAM)
    _assert_same(committed, export_sampler(compile_cultivation()), skip=_replay_skip(committed))
    prog = committed.program
    assert committed.num_detectors == 11 and prog.num_outputs == 12
    rungs = prog.components[0].compiled_scalar_graphs
    assert [c.num_graphs for c in rungs] == [1, 4, 168, 205, 235, 32, 32, 32, 32, 307]
    r = committed.replay
    assert r["noise_uniforms"].shape == (REPLAY_ROWS, len(committed.noise.channels))
    assert r["draw_uniforms"].shape == (len(rungs) - 1, REPLAY_ROWS)
    assert r["bits"].shape == (REPLAY_ROWS, 12) and r["bits"].dtype == np.uint8
    assert committed.meta["replay_norm_deviation"] <= 1e-5
    # tsim_tpu's postselected reference: all detectors masked, both references on.
    meta = committed.meta
    assert meta["reference_shots"] == POSTSELECTED_SHOTS
    assert meta["survivor_fraction"] == meta["reference_survivors"] / POSTSELECTED_SHOTS
    assert 0.9 < meta["survivor_fraction"] < 1
    means = r["survivor_means"]
    assert means.shape == (12,) and not means[:11].any() and 0 < means[11] < 1
    assert r["reference_sample"].shape == (12,) and r["reference_sample"].dtype == np.uint8


def test_committed_cultivation_checks1_equals_fresh_export():
    committed = program_io.load_npz(CULTIVATION_CHECKS1_PROGRAM)
    _assert_same(
        committed, export_sampler(compile_cultivation(checks=1)), skip=("reference_means", "meta")
    )
    prog = committed.program
    assert committed.num_detectors == 10 and prog.num_outputs == 11
    rungs = prog.components[0].compiled_scalar_graphs
    assert [c.num_graphs for c in rungs] == [1, 4, 8, 8, 16, 16, 16, 16, 64]
    assert committed.meta["reference_shots"] == CHECKS1_SHOTS
    means = committed.reference_means
    assert means.shape == (11,) and ((means > 0) & (means < 1)).all()


def test_port_runs_without_jax():
    script = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = None  # any import of jax now raises
        from tsim_tpu_torch.models.exported import distillation_d3
        out = distillation_d3(p=0.05).compile_detector_sampler(seed=0, device="cpu").sample(
            1024, batch_size=512, append_observables=True)
        assert out.shape == (1024, 20), out.shape
        d3 = distillation_d3(p=0.05)
        state = d3.load_state_probs().replay["states"][1]
        p = d3.compile_state_probs(seed=0, device="cpu").probability_of(state, batch_size=64)
        assert p.shape == (64,), p.shape
        from tsim_tpu_torch.models.exported import cultivation_d3
        out = cultivation_d3(p=0.001, checks=2).compile_detector_sampler(
            seed=0, device="cpu", evaluation="exact").sample(64, batch_size=64)
        assert out.shape == (64, 11), out.shape
        det, obs = cultivation_d3(p=0.001, checks=2).compile_detector_sampler(
            seed=0, device="cpu").sample(
            64, batch_size=32, postselection_mask=[True] * 11, separate_observables=True,
            use_detector_reference_sample=True, use_observable_reference_sample=True)
        assert det.shape == (64, 11) and obs.shape == (64, 1), (det.shape, obs.shape)
        out = cultivation_d3(p=0.001, checks=1).compile_detector_sampler(seed=0, device="cpu").sample(64)
        assert out.shape == (64, 10), out.shape
        import torch
        if not torch.cuda.is_available():
            try:
                cultivation_d3(p=0.001, checks=1).compile_detector_sampler(seed=0)
            except RuntimeError as exc:
                assert 'device="cpu"' in str(exc)
            else:
                raise AssertionError("no device and no card must raise")
        from tsim_tpu_torch.compile import sample_eval
        tables, rows = sample_eval.probe_inputs("cpu")
        import dev.torch_kernel_ablate
        bad = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "tsim_tpu.")) or m == "tsim_tpu"]
        assert bad == ["jax"], bad
        print("ok")
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
