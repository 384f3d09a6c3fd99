"""Circuits whose compiled programs are committed as data (``programs/*.npz``).

Each workload's programs were compiled by ``tsim_tpu`` and exported, with
``tsim_tpu``'s reference means and replays, by
``python dev/export_torch_program.py``. The tests and ``chip_smoke.py`` hold
the port against them where JAX is absent: the port's own compile of each
circuit must equal its file leaf for leaf, and its samples must agree with
the means and replays. The builders in ``models/`` compile any argument;
these loaders cover only the committed ones.
"""

from __future__ import annotations

from pathlib import Path

from ..program_io import ExportedProgram, load_npz
from ..sampler import CompiledDetectorSampler, CompiledStateProbs

PROGRAM_DIR = Path(__file__).resolve().parents[1] / "programs"

D3_PROGRAM = PROGRAM_DIR / "distillation_d3_p0.05.npz"
D3_STATE_PROBS_PROGRAM = PROGRAM_DIR / "distillation_d3_p0.05_state_probs.npz"
D5_PROGRAM = PROGRAM_DIR / "distillation_d5_p0.02.npz"
CULTIVATION_PROGRAM = PROGRAM_DIR / "cultivation_d3_p0.001_checks2.npz"
CULTIVATION_CHECKS1_PROGRAM = PROGRAM_DIR / "cultivation_d3_p0.001_checks1.npz"
# Fully direct: the reference for the frame engine and the DEM (its meta
# holds the sha256 of tsim_tpu's DEM text); load it with program_io.load_npz.
SURFACE_D7_PROGRAM = PROGRAM_DIR / "surface_code_d7_p0.001.npz"
_CULTIVATION_PROGRAMS = {1: CULTIVATION_CHECKS1_PROGRAM, 2: CULTIVATION_PROGRAM}


class ExportedCircuit:
    """A circuit with a committed detector-sampler program and, optionally,
    a committed state-probability (joint-mode) program."""

    def __init__(self, path: Path, state_probs_path: Path | None = None):
        self.path = path
        self.state_probs_path = state_probs_path

    def load(self) -> ExportedProgram:
        return load_npz(self.path)

    def load_state_probs(self) -> ExportedProgram:
        if self.state_probs_path is None:
            raise NotImplementedError(
                f"{self.path.name}: no state-probability program is exported for this circuit"
            )
        return load_npz(self.state_probs_path)

    def compile_detector_sampler(
        self, *, seed: int | None = None, device=None, evaluation: str = "f32",
        per_term: bool | None = None, mesh="auto",
    ) -> CompiledDetectorSampler:
        return CompiledDetectorSampler(
            self.load(), seed=seed, device=device, evaluation=evaluation, per_term=per_term,
            mesh=mesh,
        )

    def compile_state_probs(
        self, *, seed: int | None = None, device=None, mesh="auto"
    ) -> CompiledStateProbs:
        return CompiledStateProbs(self.load_state_probs(), seed=seed, device=device, mesh=mesh)


def distillation_d3(p: float = 0.05) -> ExportedCircuit:
    """The committed programs of ``models.distillation_d3(p=0.05)``: its
    detector sampler and its state probabilities."""
    if p != 0.05:
        raise NotImplementedError(
            f"exported distillation_d3(p={p}): only p=0.05 is committed; compile other "
            "error rates with tsim_tpu_torch.models.distillation_d3(p)"
        )
    return ExportedCircuit(D3_PROGRAM, D3_STATE_PROBS_PROGRAM)


def distillation_d5(p: float = 0.02) -> ExportedCircuit:
    """The committed detector-sampler program of ``models.distillation_d5(p=0.02)``."""
    if p != 0.02:
        raise NotImplementedError(
            f"exported distillation_d5(p={p}): only p=0.02 is committed; compile other "
            "error rates with tsim_tpu_torch.models.distillation_d5(p)"
        )
    return ExportedCircuit(D5_PROGRAM)


def cultivation_d3(p: float = 0.001, checks: int = 1) -> ExportedCircuit:
    """The committed detector-sampler programs of ``models.cultivation_d3(p=0.001,
    checks=c)`` for c = 1 and 2."""
    if p != 0.001 or checks not in _CULTIVATION_PROGRAMS:
        raise NotImplementedError(
            f"exported cultivation_d3(p={p}, checks={checks}): only p=0.001 with checks 1 "
            "or 2 is committed; compile other arguments with "
            "tsim_tpu_torch.models.cultivation_d3(p, checks=checks)"
        )
    return ExportedCircuit(_CULTIVATION_PROGRAMS[checks])
