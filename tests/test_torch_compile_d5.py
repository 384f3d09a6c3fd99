"""d5 distillation (85 qubits) through the port's host compile path, on the CPU.

Its own file, so that ``--dist loadfile`` runs its compiles beside the
others. The port's compile of ``distillation_d5(p=0.02)`` (one per module)
equals tsim_tpu's and the committed ``programs/distillation_d5_p0.02.npz``
leaf for leaf, and the planner pins of
``tests/integration/test_distillation_d5.py`` hold for the port.
"""

from __future__ import annotations

import pytest

from tests.helpers import requires_native_planner
from tests.test_torch_compile_parity import assert_same_leaves, reference_compile
from tsim_tpu_torch.models import distillation_d5
from tsim_tpu_torch.models.exported import D5_PROGRAM
from tsim_tpu_torch.program_io import load_npz
from tsim_tpu_torch.sampler import compile_circuit


def _rung_counts(exported) -> list[int]:
    return [c.num_graphs for comp in exported.program.components for c in comp.compiled_scalar_graphs]


@pytest.fixture(scope="module")
def d5():
    circuit = distillation_d5(p=0.02)
    exported, stats = compile_circuit(circuit, sample_detectors=True, mode="sequential")
    return circuit, exported, stats


def test_d5_compile_equals_tsim_tpu(d5):
    circuit, exported, _ = d5
    assert circuit.num_qubits == 85 and circuit.num_detectors == 40
    assert_same_leaves(exported, reference_compile(str(circuit), sample_detectors=True, mode="sequential"))


@requires_native_planner()
def test_d5_compile_equals_committed_program(d5):
    _, exported, stats = d5
    assert stats["planner"] == "native"
    assert_same_leaves(exported, load_npz(D5_PROGRAM))
    counts = _rung_counts(exported)
    assert max(counts) == 138 and sum(counts) == 332, counts


@requires_native_planner()
def test_d5_term_count_pin():
    """tsim_tpu's planner pin for d5 (``test_d5_term_count_pin``, p = 0.04),
    held by the port: largest rung at most 138, total at most 332."""
    exported, _ = compile_circuit(distillation_d5(p=0.04), sample_detectors=True, mode="sequential")
    counts = _rung_counts(exported)
    assert max(counts) <= 138, counts
    assert sum(counts) <= 332, counts
