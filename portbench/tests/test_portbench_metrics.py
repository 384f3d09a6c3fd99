"""Each per-layer metric's arithmetic on a synthetic traced record, the
trace reductions and the breakdown."""

import pytest

from portbench import cells, readers, tracing

WIN = (1000.0, 11000.0)  # a 10 ms traced span


def record(device=(), host=(), devices=(0,), **counts):
    base = {"window_us": WIN, "device": list(device), "host": list(host), "devices": list(devices),
            "rows": 1000, "steps": 4, "evaluated_rows": 1000, "work": None}
    base.update(counts)
    return base


def k(name, start, end, dev=0, kind="kernel"):
    return (name, dev, float(start), float(end), kind)


def read(name, rec):
    return cells.metric_reader(name).read(rec)


def test_union_merges_overlaps():
    assert tracing.union_us([(0, 10), (5, 15), (20, 30)]) == 25
    assert tracing.union_us([]) == 0


def test_device_idle_pct_counts_kernels_copies_and_memsets_once():
    rec = record(device=[k("void sample_eval_wide<1>(...)", 1000, 3000),
                         k("Memcpy DtoH (Device -> Pinned)", 2000, 4000, kind="memcpy"),
                         k("noise_draw(...)", 10500, 12000)])
    # busy 1000..4000 and 10500..11000 inside the span: 3.5 of 10 ms
    assert read("device_idle_pct", rec) == pytest.approx(65.0)
    assert read("device_idle_pct.postsel", rec) == pytest.approx(65.0)
    assert read("device_idle_pct", record()) is None


def test_idle_pct_is_taken_per_card():
    rec = record(device=[k("a", 1000, 6000, dev=0), k("b", 1000, 2000, dev=1)], devices=[0, 1])
    assert tracing.idle_pct(rec, 0) == pytest.approx(50.0)
    assert tracing.idle_pct(rec, 1) == pytest.approx(90.0)


def test_the_traced_part_is_the_hull_of_the_metrics_spans():
    assert tracing.hull([(0.1, 1.0), (0.2, 0.5)]) == (0.1, 1.0)
    assert tracing.hull([(0.3, 0.6), (0.5, 0.9)]) == (0.3, 0.9)
    for bad in [(0.5, 0.5), (-0.1, 0.5), (0.2, 1.5)]:
        with pytest.raises(ValueError):
            tracing.hull([bad])


def traced_record():
    """Ten calls of 1 ms each, one a ms from 1000 us, traced from 0.1 to
    1.0 of the window (the traced part is the hull of one span)."""
    host = [("sample", 1, 1000.0 + 1000 * i, 2000.0 + 1000 * i) for i in range(10)]
    rec = record(host=host, shares=(0.1, 1.0))
    rec["calls"] = tracing.calls_on_trace(rec, [{"rows": 100, "steps": 2, "evaluated_rows": 50}] * 10)
    rec.update(tracing.counts(rec["calls"]))
    return rec


def test_calls_take_their_times_from_the_trace_and_sum_to_the_counts():
    rec = traced_record()
    assert [c["start_us"] for c in rec["calls"][:2]] == [1000.0, 2000.0]
    assert (rec["rows"], rec["steps"], rec["evaluated_rows"]) == (1000, 20, 500)


def test_a_span_view_cuts_the_record_and_its_counts():
    rec = traced_record()
    assert tracing.span_view(rec, (0.1, 1.0)) is rec
    assert tracing.span_view(rec, (0.0, 1.0)) is rec
    # 0.1 .. 1.0 of the window is 1000 .. 11000 us: 0.65 .. 1.0 is 7111 .. 11000,
    # and only the calls that lie wholly inside it count.
    late = tracing.span_view(rec, (0.65, 1.0))
    assert late["window_us"] == pytest.approx((1000 + 0.55 / 0.9 * 10000, 11000.0))
    assert (late["rows"], late["steps"], late["evaluated_rows"]) == (300, 6, 150)
    assert rec["window_us"] == WIN and rec["rows"] == 1000


def test_host_sync_ms_per_batch_sums_blocking_runtime_calls_over_steps():
    rec = record(host=[("cudaStreamSynchronize", 1, 2000, 3000), ("cudaEventSynchronize", 1, 4000, 4500),
                       ("cudaLaunchKernel", 1, 5000, 9000), ("cudaMemcpy", 1, 10500, 12000)])
    assert read("host_sync_ms_per_batch", rec) == pytest.approx((1000 + 500 + 500) / 1e3 / 4)
    assert read("host_sync_ms_per_batch", record(steps=0)) is None


def test_ladder_glue_takes_every_other_kernel():
    rec = record(device=[k("void sample_eval_small(...)", 1000, 2000), k("exact_wide(...)", 2000, 2500),
                         k("noise_draw", 2500, 2600), k("void at::native::cat(...)", 3000, 3400),
                         k("void at::native::index_kernel(...)", 4000, 4200),
                         k("Memset (Device)", 5000, 5100, kind="memset")])
    assert read("ladder_glue_ms_per_batch", rec) == pytest.approx(0.6 / 4)


def linear_work(evaluation, eval_ms_per_row=1e-5, noise_ms_per_row=2e-6, launches=3):
    return {"evaluation": evaluation, "eval_launches": launches,
            "eval_least_ms": lambda rows: eval_ms_per_row * rows,
            "noise_least_ms": lambda rows: noise_ms_per_row * rows}


def test_rooflines_divide_the_least_time_by_the_kernels_device_time():
    # two rounds of three f32 launches, 1 ms each: 6 ms of device time for
    # 1000 rows at 1e-5 ms a row a round of launches: 0.01 ms.
    evals = [k("void sample_eval_wide<1>(...)", 1000 + 1000 * i, 2000 + 1000 * i) for i in range(6)]
    rec = record(device=evals + [k("noise_draw", 8000, 8100), k("noise_draw", 8200, 8300)],
                 work=linear_work("f32"))
    assert read("f32_eval_roofline", rec) == pytest.approx(100 * 1e-5 * 1000 / 6.0)
    assert read("f32_eval_roofline.postsel", rec) == pytest.approx(100 * 1e-5 * 1000 / 6.0)
    assert read("exact_eval_roofline", rec) is None
    assert read("noise_draw_roofline", rec) == pytest.approx(100 * 2e-6 * 1000 / 0.2)
    step = 100 * (2e-6 * 1000 + 1e-5 * 1000) / 1e3 / 0.01
    assert read("step_mfu", rec) == pytest.approx(step)
    assert read("step_mfu.postsel", rec) == pytest.approx(step)


def test_exact_roofline_reads_exact_and_approximate_kernels():
    evals = [k("exact_wide(unsigned char const*, long long, int, Tables, int*, int*)", 1000, 3000),
             k("approx_small(...)", 3000, 4000)]
    rec = record(device=evals, work=linear_work("exact", launches=2))
    assert read("exact_eval_roofline", rec) == pytest.approx(100 * 1e-5 * 1000 / 3.0)
    assert read("f32_eval_roofline", rec) is None


def test_a_reader_with_nothing_to_read_returns_nothing():
    rec = record(work=linear_work("f32"))
    for name in ("f32_eval_roofline", "noise_draw_roofline", "step_mfu", "ladder_glue_ms_per_batch"):
        assert read(name, rec) is None


def test_kernels_outside_the_span_are_not_counted():
    rec = record(device=[k("void sample_eval_small(...)", 0, 900), k("void sample_eval_small(...)", 2000, 3000)],
                 work=linear_work("f32", launches=1))
    assert len(readers.kernels(rec, readers.F32_EVAL)) == 1


def test_breakdown_names_ops_and_gaps_by_the_host():
    rec = record(device=[k("K1", 1000, 4000), k("K2", 6000, 7000), k("K1", 9000, 10000)],
                 host=[(tracing.WINDOW, 1, 1000, 11000), (tracing.CALL, 1, 1000, 7500),
                       ("aten::copy_", 1, 4000, 6000)])
    ops = tracing.device_ops(rec)
    assert ops[0] == ["K1", pytest.approx(4e-3)] and ops[1] == ["K2", pytest.approx(1e-3)]
    gaps = tracing.idle_gaps(rec, 0)
    assert gaps[0] == ["sample>aten::copy_", pytest.approx(2e-3)]
    assert gaps[1] == ["between calls", pytest.approx(2e-3)]
    assert gaps[2] == ["between calls", pytest.approx(1e-3)]
    assert tracing.busy_s(rec, 0) == pytest.approx(5e-3)
    assert tracing.window_s(rec) == pytest.approx(1e-2)


def test_kernel_name_patterns():
    assert readers.F32_EVAL.search("void sample_eval_per_term_wide_regs(unsigned char const*)")
    assert not readers.F32_EVAL.search("void my_sample_eval(...)")
    assert readers.EXACT_EVAL.search("approx_wide(unsigned char const*)")
    assert not readers.EXACT_EVAL.search("exact_wide_thing")
    assert readers.NOISE_DRAW.search("noise_draw(float const*, long long)")
