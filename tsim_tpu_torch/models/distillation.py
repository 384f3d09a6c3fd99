"""Distillation workloads, loaded from programs exported by ``tsim_tpu``.

``tsim_tpu.models.distillation.distillation_d3(p=0.05)`` compiled with
``compile_detector_sampler(seed=0)`` is committed as
``programs/distillation_d3_p0.05.npz`` (re-export it with
``python dev/export_torch_program.py``). Other error rates need the
port's own host compiler, which does not exist yet.
"""

from __future__ import annotations

from pathlib import Path

from ..program_io import ExportedProgram, load_npz
from ..sampler import CompiledDetectorSampler

PROGRAM_DIR = Path(__file__).resolve().parents[1] / "programs"
D3_PROGRAM = PROGRAM_DIR / "distillation_d3_p0.05.npz"


class ExportedCircuit:
    """A circuit whose compiled program is committed as data."""

    def __init__(self, path: Path):
        self.path = path

    def load(self) -> ExportedProgram:
        return load_npz(self.path)

    def compile_detector_sampler(self, *, seed: int | None = None, device=None) -> CompiledDetectorSampler:
        return CompiledDetectorSampler(self.load(), seed=seed, device=device)


def distillation_d3(p: float = 0.05) -> ExportedCircuit:
    """35-qubit d=3 15-to-1 distillation ([[7,1,3]] Steane-encoded)."""
    if p != 0.05:
        raise NotImplementedError(
            f"distillation_d3(p={p}): only p=0.05 is exported; other error rates "
            "need a host compile path without JAX, which is a later part of the port"
        )
    return ExportedCircuit(D3_PROGRAM)
