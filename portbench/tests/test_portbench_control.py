"""The controls of the check that decides ``correct``. In the f32 cells:
the reference put in the program's place with every intermediate rounded
to bfloat16 (the precision below the float32 that the f32 evaluation
states) fails the check at the judged size, where draws from the float64
reference pass it. In the exact cell: the program's own float32 path fails
``norm_off_share`` on the card, where the exact path passes; on the CPU a
deviation planted in the exact cell's timed path fails it. The readings
on the card come from ``portbench/readings.py``; a few are ``cuda`` tests
here."""

import numpy as np
import pytest

from portbench import cells, judge, readings
from portbench.reference.density import output_distribution

CELLS = ["cult1.f32", "cult2.exact", "cult2.postsel"]
F32_CELLS = ["cult1.f32", "cult2.postsel"]


@pytest.mark.parametrize("name", F32_CELLS)
def test_control_fails_where_the_reference_passes(name):
    cell = cells.load_cell(name)
    for r in readings.control_readings(cell, [1, 2, 3]):
        assert r["control"] == "bfloat16 reference"
        assert r["max_abs_z"] > 3 * judge.MAX_ABS_Z_LIMIT, r


@pytest.mark.parametrize("name", CELLS)
def test_draws_from_the_reference_pass(name):
    cell = cells.load_cell(name)
    traffic = cell.traffic
    nd = cell.config.num_detectors
    columns = nd + (cell.config.num_observables if traffic.append_observables else 0)
    q, _ = output_distribution(cell.config.circuit_text)
    q = judge.marginal(q, nd, traffic.append_observables)
    rows = judge.kept_calls(traffic.shots) * traffic.shots
    for seed in (1, 2, 3):
        hist = np.random.default_rng(seed).multinomial(rows, np.clip(q, 0, None) / np.clip(q, 0, None).sum())
        checks = judge.checks_of(hist, q, columns, nd, traffic.postselection is not None, 0)
        assert checks["max_abs_z"]["value"] < judge.MAX_ABS_Z_LIMIT, checks
        assert checks["max_abs_z"]["events"] >= (2 if traffic.postselection else 20)


def test_bounds_take_the_programs_largest_and_the_controls_smallest():
    reading = readings.bounds([{"max_abs_z": 2.0, "norm_off_share": 0.0}, {"norm_off_share": 0.01}],
                              [{"max_abs_z": 1.5, "norm_off_share": 1.0}, {"norm_off_share": 0.9}])
    assert reading["norm_off_share"] == {"lower": 0.01, "upper": 0.9}
    assert reading["max_abs_z"] == {"lower": 2.0, "upper": 1.5}


@pytest.mark.cuda
def test_program_reading_on_the_card(cuda_card):
    r = readings.program_reading(cells.load_cell("cult1.f32"), 12345)
    assert r["repeated_chunks"] == 0 and r["max_abs_z"] < judge.MAX_ABS_Z_LIMIT, r


@pytest.mark.cuda
def test_f32_path_fails_the_exact_cells_check_on_the_card(cuda_card):
    cell = cells.load_cell("cult2.exact")
    sound = readings.program_reading(cell, 54321, seconds=10.0)
    control = readings.program_reading(cell, 54321, evaluation="f32", seconds=10.0)
    assert sound["norm_off_share"] <= judge.NORM_OFF_SHARE_LIMIT < control["norm_off_share"], (sound, control)
