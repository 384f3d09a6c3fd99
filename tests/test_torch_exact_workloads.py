"""The port's plain exact evaluator against tsim_tpu's on every rung of the
three workloads whose programs the port carries: d3 distillation, d3 state
probabilities and 2-check cultivation, each compiled here by tsim_tpu, at
256 seeded rows per rung. Tolerances as in ``test_torch_exact_eval.py``:
exact graph sums integer for integer and their magnitudes bit for bit,
``evaluate_abs`` itself within its XLA ``exp2`` error; approximate rungs
within rtol 1e-6.
"""

import pytest

from dev.export_torch_program import compile_cultivation, compile_d3, compile_d3_state_probs
from tests.test_torch_exact_eval import _check_rung, _rows

_WORKLOADS = {
    "d3": (compile_d3, [1, 5, 6, 103, 60, 103]),
    "d3_state_probs": (compile_d3_state_probs, [1, 172]),
    "cultivation": (compile_cultivation, [1, 4, 168, 205, 235, 32, 32, 32, 32, 307]),
}


@pytest.fixture(scope="module")
def workload_rungs():
    """Every rung of each workload, compiled by tsim_tpu (about 20 s in all)."""
    out = {}
    for name, (make, _) in _WORKLOADS.items():
        program = make()._program
        out[name] = [c for comp in program.components for c in comp.compiled_scalar_graphs]
    return out


@pytest.mark.parametrize("name", sorted(_WORKLOADS))
def test_workload_graph_counts(workload_rungs, name):
    assert [c.num_graphs for c in workload_rungs[name]] == _WORKLOADS[name][1]


@pytest.mark.parametrize(
    "name, index", [(n, i) for n, (_, graphs) in _WORKLOADS.items() for i in range(len(graphs))]
)
def test_workload_rungs_match(workload_rungs, name, index):
    csg = workload_rungs[name][index]
    _check_rung(csg, _rows(csg.n_params, 256, 100 + index))


def test_cultivation_rungs_are_dyadic(workload_rungs):
    """2-check cultivation reaches K5/K7a only; d3's wide rungs reach K6/K7b."""
    assert not any(c.prefactor.has_approximate_floatfactors for c in workload_rungs["cultivation"])
    assert all(c.prefactor.has_approximate_floatfactors for c in workload_rungs["d3"][1:])
