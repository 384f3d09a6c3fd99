"""Circuits whose compiled programs are committed as data (``programs/*.npz``).

The port has no host compiler of its own yet: each workload's programs
are compiled by ``tsim_tpu`` and exported with
``python dev/export_torch_program.py``.
"""

from __future__ import annotations

from pathlib import Path

from ..program_io import ExportedProgram, load_npz
from ..sampler import CompiledDetectorSampler, CompiledStateProbs

PROGRAM_DIR = Path(__file__).resolve().parents[1] / "programs"


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
        per_term: bool | None = None,
    ) -> CompiledDetectorSampler:
        return CompiledDetectorSampler(
            self.load(), seed=seed, device=device, evaluation=evaluation, per_term=per_term
        )

    def compile_state_probs(self, *, seed: int | None = None, device=None) -> CompiledStateProbs:
        return CompiledStateProbs(self.load_state_probs(), seed=seed, device=device)
