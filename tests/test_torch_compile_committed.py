"""The port's compile of the committed workloads equals each committed program.

``programs/*.npz`` were compiled by tsim_tpu (``dev/export_torch_program.py``).
The port compiles the same circuits itself, with no JAX involved, and each
result must equal its file leaf for leaf (program, noise model, detector
count): d3 distillation's detector sampler and state probabilities, 1-check
cultivation here; 2-check cultivation in ``test_torch_compile_committed_checks2.py``
and d5 in ``test_torch_compile_d5.py``. The committed programs were planned
by the native engine, so these need it (``requires_native_planner``). The
same gate runs on the card's machine (``chip_smoke.py`` phase 19).
"""

from __future__ import annotations

import pytest

from tests.helpers import requires_native_planner
from tests.test_torch_compile_parity import assert_same_leaves
from tsim_tpu_torch.models import cultivation_d3, distillation_d3
from tsim_tpu_torch.models.exported import (
    CULTIVATION_CHECKS1_PROGRAM,
    D3_PROGRAM,
    D3_STATE_PROBS_PROGRAM,
)
from tsim_tpu_torch.program_io import load_npz
from tsim_tpu_torch.sampler import compile_circuit

WORKLOADS = {
    "d3": (lambda: distillation_d3(p=0.05), True, "sequential", D3_PROGRAM),
    "d3_state_probs": (lambda: distillation_d3(p=0.05), False, "joint", D3_STATE_PROBS_PROGRAM),
    "cultivation_checks1": (
        lambda: cultivation_d3(p=0.001, checks=1), True, "sequential", CULTIVATION_CHECKS1_PROGRAM
    ),
}


@requires_native_planner()
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_port_compile_equals_committed_program(name):
    build, sample_detectors, mode, path = WORKLOADS[name]
    exported, stats = compile_circuit(build(), sample_detectors=sample_detectors, mode=mode)
    assert stats["planner"] == "native"
    assert_same_leaves(exported, load_npz(path))


@requires_native_planner()
def test_d3_term_count_pin():
    """tsim_tpu's planner pin for d3 (``test_d3_term_count_pin``, p = 0.05),
    held by the port: largest rung at most 103, total at most 278."""
    exported, _ = compile_circuit(distillation_d3(p=0.05), sample_detectors=True, mode="sequential")
    counts = [c.num_graphs for comp in exported.program.components for c in comp.compiled_scalar_graphs]
    assert max(counts) <= 103, counts
    assert sum(counts) <= 278, counts
