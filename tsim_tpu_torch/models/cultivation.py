"""Magic-state cultivation workloads, loaded from programs exported by ``tsim_tpu``.

``tsim_tpu.models.cultivation.cultivation_d3(p=0.001, checks=c)`` compiled
with ``compile_detector_sampler(seed=0)`` is committed as
``programs/cultivation_d3_p0.001_checks{c}.npz`` for c = 1 and 2 (re-export
them with ``python dev/export_torch_program.py``). Other arguments need the
port's own host compiler, which does not exist yet.
"""

from __future__ import annotations

from .exported import PROGRAM_DIR, ExportedCircuit

CULTIVATION_PROGRAM = PROGRAM_DIR / "cultivation_d3_p0.001_checks2.npz"
CULTIVATION_CHECKS1_PROGRAM = PROGRAM_DIR / "cultivation_d3_p0.001_checks1.npz"
_PROGRAMS = {1: CULTIVATION_CHECKS1_PROGRAM, 2: CULTIVATION_PROGRAM}


def cultivation_d3(p: float = 0.001, checks: int = 1) -> ExportedCircuit:
    """d=3 cultivation: inject |H_XY> into the Steane code, check it ``checks`` times.

    The defaults are ``tsim_tpu``'s; ``checks`` 1 and 2 are exported.
    """
    if p != 0.001 or checks not in _PROGRAMS:
        raise NotImplementedError(
            f"cultivation_d3(p={p}, checks={checks}): only p=0.001 with checks 1 or 2 is "
            "exported; other arguments need a host compile path without JAX, which is a "
            "later part of the port"
        )
    return ExportedCircuit(_PROGRAMS[checks])
