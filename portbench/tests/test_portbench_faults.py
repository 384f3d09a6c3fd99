"""A whole run of the harness on the CPU, at a small size, with the timed
path broken underneath: ``correct`` has to come out false for each fault
the cells can have, and true for the unbroken path. The run's look for a
card is skipped (``run_cell`` is called with ``device="cpu"``); the cell
is 1-check cultivation with 2^13 shots a call in batches of 2^12, and a
run judges four calls."""

import dataclasses
import time

import numpy as np
import pytest

from portbench import cells, judge, run

SEED = 2**33 + 5


def small_cell(name="cult1.f32", **traffic):
    cell = cells.load_cell(name)
    t = dataclasses.replace(cell.traffic, shots=1 << 13, batch_size=1 << 12, mesh=None, **traffic)
    return dataclasses.replace(cell, traffic=t)


@pytest.fixture
def small_judge(monkeypatch):
    monkeypatch.setattr(judge, "JUDGED_ROWS", 1 << 15)
    monkeypatch.setattr(judge, "MAX_OFFSET", 2)


def run_small(cell, seconds=2.0, trace=False):
    result, checks, notes = run.run_cell(cell.name, SEED, seconds, trace, device="cpu", cell=cell,
                                         started=time.perf_counter())
    checks["rows_judged"] = notes["rows_judged"]
    return result, checks


@pytest.fixture
def sampler_module():
    from tsim_tpu_torch import sampler

    return sampler


def test_unbroken_run_is_correct(small_judge):
    result, checks = run_small(small_cell())
    assert result["correct"], checks
    assert checks["rows_judged"] == 4 << 13
    assert list(result["checks"]) == ["max_abs_z", "repeated_chunks"]


def test_step_that_leaves_its_state_unchanged(small_judge, monkeypatch, sampler_module):
    original = sampler_module._CompiledSamplerBase._sample_batch

    def frozen(self, shots, stage=None, shard=None):
        shard = shard or self._shards_for(shots)[0]
        state = shard.generator.get_state()
        try:
            return original(self, shots, stage, shard)
        finally:
            shard.generator.set_state(state)

    monkeypatch.setattr(sampler_module._CompiledSamplerBase, "_sample_batch", frozen)
    result, checks = run_small(small_cell())
    assert checks["repeated_chunks"]["value"] > 0
    assert not result["correct"]


def test_half_of_the_batch_left_out(small_judge, monkeypatch, sampler_module):
    original = sampler_module.sample_program_with_deviation

    def half(tables, f_params, generator, uniforms=None):
        out, dev = original(tables, f_params, generator, uniforms)
        out = out.clone()
        out[out.shape[0] // 2:] = 0
        return out, dev

    monkeypatch.setattr(sampler_module, "sample_program_with_deviation", half)
    result, checks = run_small(small_cell())
    assert checks["max_abs_z"]["value"] > judge.MAX_ABS_Z_LIMIT
    assert not result["correct"]


def test_the_exchange_between_cards_left_out(small_judge, monkeypatch, sampler_module):
    from tsim_tpu_torch.parallel.shard import ShotMesh

    original = sampler_module._RowsToHost.push
    first_of_call = {}

    def first_card_only(self, bits, start):
        # The first sink a call makes is the first shard's: every other
        # shard's rows never reach the result.
        first_of_call.setdefault(id(self.result), self)
        if first_of_call[id(self.result)] is self:
            original(self, bits, start)

    monkeypatch.setattr(sampler_module._RowsToHost, "push", first_card_only)
    cell = small_cell()
    cell = dataclasses.replace(cell, traffic=dataclasses.replace(cell.traffic, mesh=ShotMesh(["cpu"] * 2)))
    result, checks = run_small(cell)
    assert not result["correct"], checks


def test_an_answer_altered_where_it_is_produced(small_judge, monkeypatch, sampler_module):
    original = sampler_module.sample_program_with_deviation

    def altered(tables, f_params, generator, uniforms=None):
        out, dev = original(tables, f_params, generator, uniforms)
        out = out.clone()
        out[::64, 0] ^= 1
        return out, dev

    monkeypatch.setattr(sampler_module, "sample_program_with_deviation", altered)
    result, checks = run_small(small_cell())
    assert checks["max_abs_z"]["value"] > judge.MAX_ABS_Z_LIMIT
    assert not result["correct"]


def test_a_call_that_raises_fails_the_run(small_judge, monkeypatch, sampler_module):
    calls = {"n": 0}
    original = sampler_module.CompiledDetectorSampler.sample

    def flaky(self, *a, **kw):
        calls["n"] += 1
        if calls["n"] == 17:  # past the warm-up (14 calls on the CPU)
            raise RuntimeError("a planted fault")
        return original(self, *a, **kw)

    monkeypatch.setattr(sampler_module.CompiledDetectorSampler, "sample", flaky)
    result, _ = run_small(small_cell())
    assert result["failed"] == 1 and not result["correct"]


def exact_cell():
    """The exact cell's traffic on the 1-check configuration, which
    compiles in seconds on the CPU."""
    cell = small_cell("cult2.exact")
    return dataclasses.replace(cell, config=cells.load_config("cultivation_d3_c1"))


def test_exact_cell_holds_the_normalization(small_judge):
    result, checks = run_small(exact_cell())
    assert result["correct"], checks
    assert list(result["checks"]) == ["max_abs_z", "repeated_chunks", "norm_off_share"]
    assert checks["norm_off_share"]["value"] <= judge.NORM_OFF_SHARE_LIMIT


def test_a_normalization_off_by_rounding_fails_the_exact_cell(small_judge, monkeypatch, sampler_module):
    # The deviation of a float32 evaluation (one float32 step below 1),
    # planted in the timed path.
    original = sampler_module.sample_program_with_deviation

    def rounded(tables, f_params, generator, uniforms=None):
        out, dev = original(tables, f_params, generator, uniforms)
        return out, dev + 2.0**-24

    monkeypatch.setattr(sampler_module, "sample_program_with_deviation", rounded)
    result, checks = run_small(exact_cell())
    assert checks["max_abs_z"]["value"] < judge.MAX_ABS_Z_LIMIT
    assert checks["norm_off_share"]["value"] > judge.NORM_OFF_SHARE_LIMIT
    assert not result["correct"]


def test_traced_run_holds_the_profiler_over_the_metrics_span(small_judge):
    result, checks = run_small(small_cell(), seconds=3.0, trace=True)
    assert result["correct"], checks
    span = cells.metric_reader("device_idle_pct").SPAN
    window = result["device"]["window_s"]
    # The traced part starts with the first call after the span's start
    # and ends with the window.
    assert 0 < window <= (span[1] - span[0]) * 3.0 + 0.5
    assert "setup_s" not in result["metrics"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_judged_calls_come_from_the_seed():
    offsets = {judge.first_kept(s) for s in range(2**31, 2**31 + 64)}
    assert offsets == set(range(judge.MAX_OFFSET))
    assert judge.kept_calls(1 << 20) == 16 and judge.kept_calls(1 << 22) == 4
    rows = np.zeros((judge.CHUNK_ROWS * 2, 3), dtype=bool)
    rows[5, 1] = True
    assert judge.repeated_chunks([rows]) == 0
    assert judge.repeated_chunks([rows, rows]) == 2


def test_postselected_run_counts_survivors_from_the_judged_rows(small_judge):
    cell = small_cell("cult2.postsel")
    cell = dataclasses.replace(cell, config=cells.load_config("cultivation_d3_c1"))
    result, checks = run_small(cell)
    assert result["correct"], checks
    rate = result["metrics"]["survivors_per_s"]["value"]
    assert rate > 0
    assert set(result["metrics"]) == {"survivors_per_s", "setup_s"}


def test_clear_share():
    rows = np.zeros((8, 3), dtype=bool)
    rows[1, 0] = rows[2, 2] = rows[3, 1] = True
    assert run.clear_share([rows], np.array([True, True, False])) == 6 / 8
    assert run.clear_share([rows, rows], np.array([False, False, True])) == 7 / 8
    assert run.clear_share([], np.array([True, True, True])) == 0.0
