"""The port's compile of 2-check cultivation equals the committed
``programs/cultivation_d3_p0.001_checks2.npz`` leaf for leaf (about 20 s of
planning on one CPU core, hence a file of its own; see
``test_torch_compile_committed.py``)."""

from __future__ import annotations

from tests.helpers import requires_native_planner
from tests.test_torch_compile_parity import assert_same_leaves
from tsim_tpu_torch.models import cultivation_d3
from tsim_tpu_torch.models.exported import CULTIVATION_PROGRAM
from tsim_tpu_torch.program_io import load_npz
from tsim_tpu_torch.sampler import compile_circuit


@requires_native_planner()
def test_port_compile_equals_committed_checks2_program():
    exported, stats = compile_circuit(
        cultivation_d3(p=0.001, checks=2), sample_detectors=True, mode="sequential"
    )
    assert stats["planner"] == "native"
    assert_same_leaves(exported, load_npz(CULTIVATION_PROGRAM))
