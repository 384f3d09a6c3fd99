"""Distillation workloads, loaded from programs exported by ``tsim_tpu``.

``tsim_tpu.models.distillation.distillation_d3(p=0.05)`` compiled with
``compile_detector_sampler(seed=0)`` is committed as
``programs/distillation_d3_p0.05.npz``, and compiled with
``compile_state_probs(seed=0)`` as
``programs/distillation_d3_p0.05_state_probs.npz`` (re-export both with
``python dev/export_torch_program.py``). Other error rates need the
port's own host compiler, which does not exist yet.
"""

from __future__ import annotations

from .exported import PROGRAM_DIR, ExportedCircuit

D3_PROGRAM = PROGRAM_DIR / "distillation_d3_p0.05.npz"
D3_STATE_PROBS_PROGRAM = PROGRAM_DIR / "distillation_d3_p0.05_state_probs.npz"


def distillation_d3(p: float = 0.05) -> ExportedCircuit:
    """35-qubit d=3 15-to-1 distillation ([[7,1,3]] Steane-encoded)."""
    if p != 0.05:
        raise NotImplementedError(
            f"distillation_d3(p={p}): only p=0.05 is exported; other error rates "
            "need a host compile path without JAX, which is a later part of the port"
        )
    return ExportedCircuit(D3_PROGRAM, D3_STATE_PROBS_PROGRAM)
