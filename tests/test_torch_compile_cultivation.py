"""1-check cultivation at p = 0.002 through the port's host compile path, on
the CPU: equal to tsim_tpu's compile leaf for leaf, through
``program_io.flatten``, dtypes included. Its own file, so that ``--dist
loadfile`` runs its compiles beside the others."""

from __future__ import annotations

from tests.test_torch_compile_parity import assert_same_leaves, port_compile, reference_compile
from tsim_tpu_torch.models import cultivation_d3


def test_cultivation_checks1_compile_equals_tsim_tpu():
    text = str(cultivation_d3(p=0.002, checks=1))
    got = port_compile(text, sample_detectors=True, mode="sequential")
    want = reference_compile(text, sample_detectors=True, mode="sequential")
    assert [c.num_graphs for c in got.program.components[0].compiled_scalar_graphs][-1] == 64
    assert_same_leaves(got, want)
