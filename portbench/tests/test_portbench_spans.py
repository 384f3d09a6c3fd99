"""The readers of the program's spans (``program_spans.py`` and the metric
files that use it): their arithmetic on synthetic records, the alignment of
the recorder's clock with the trace's, None where the program has no
recorder, and a traced CPU run with and without one."""

import dataclasses
import time

import pytest

from portbench import cells, judge, program_spans, run

WIN = (1000.0, 11000.0)
SPAN_METRICS = ["host_move_ms_per_batch", "host_wait_ms_per_batch", "plan_ms_per_call",
                "survivor_read_ms_per_chunk.postsel"]


def read(name, rec):
    return cells.metric_reader(name).read(rec)


def call_spans(t0, steps=2, postsel_reads=0):
    """The spans of one call that starts at ``t0`` (us): a 0.1 ms plan,
    ``steps`` steps of 1 ms, each followed by a 0.2 ms wait and a 0.3 ms
    move, a 0.05 ms deviation read; or ``postsel_reads`` reads of 0.4 ms."""
    spans = [("tsim.plan", t0 + 10, t0 + 110, {"batch_rows": 4, "shards": 1, "mem_reads": 1})]
    t = t0 + 200
    for _ in range(steps):
        spans += [("tsim.step", t, t + 1000, {"rows": 2}), ("tsim.to_host.wait", t + 1000, t + 1200, {}),
                  ("tsim.to_host.move", t + 1200, t + 1500, {"rows": 2, "bytes": 22})]
        t += 1500
    for _ in range(postsel_reads):
        spans.append(("tsim.postsel.read", t, t + 400, {"survivors": 3}))
        t += 500
    spans.append(("tsim.deviation.read", t, t + 50, {}))
    return [("tsim.sample", t0, t + 100, {"shots": 4})] + spans


def record(spans=None, **extra):
    rec = {"window_us": WIN, "device": [], "host": [], "devices": [0], "rows": 0, "steps": 0,
           "evaluated_rows": 0, "work": None, "calls": []}
    if spans is not None:
        rec["spans"] = spans
    rec.update(extra)
    return rec


def test_readers_divide_span_time_by_their_counts():
    # Two calls inside the span, one starting before it (left out).
    spans = call_spans(-5000) + call_spans(2000) + call_spans(6000)
    rec = record(spans)
    assert read("host_move_ms_per_batch", rec) == pytest.approx(0.3)
    assert read("host_wait_ms_per_batch", rec) == pytest.approx((4 * 0.2 + 2 * 0.05) / 4)
    assert read("plan_ms_per_call", rec) == pytest.approx(0.1)
    assert read("survivor_read_ms_per_chunk.postsel", rec) is None
    post = record(call_spans(2000, steps=0, postsel_reads=3))
    assert read("survivor_read_ms_per_chunk.postsel", post) == pytest.approx(0.4)
    assert read("host_move_ms_per_batch", post) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_record_without_spans_from_a_program_without_a_recorder_reads_nothing(name, monkeypatch):
    from tsim_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "start")  # the recorder as the program had none
    assert read(name, record()) is None
    assert read(name, record(calls=[{"start_us": 1000.0, "end_us": 2000.0}])) is None


def fake_spans(call_starts_ns):
    """Recorder spans: a ``tsim.sample`` of 1 ms at each start holding a
    0.1 ms plan."""
    from tsim_tpu_torch.utils.profiling import Span

    spans = []
    for i, t in enumerate(call_starts_ns):
        spans.append(Span("tsim.plan", 2 * i + 2, 2 * i + 1, 2 * i + 1, t + 20_000, t + 120_000, {}))
        spans.append(Span("tsim.sample", 2 * i + 1, 0, 2 * i + 1, t, t + 1_000_000, {"shots": 4}))
    return spans


def test_the_recorders_spans_are_put_on_the_traces_clock():
    # Calls every 3 ms or so, the first two before the traced part; the
    # trace's clock starts 5e9 us before the recorder's.
    starts = [int(1e6 * (3 * i + 0.01 * (i % 5) ** 2)) for i in range(12)]
    zero = 5_000_000_000_000
    calls = [{"start_us": (t - zero) / 1e3 - 0.03, "end_us": (t - zero) / 1e3 + 1001} for t in starts[2:]]
    got = program_spans.aligned(fake_spans(starts), calls)
    plans = sorted(s[1] for s in got if s[0] == "tsim.plan")
    assert plans[2] == pytest.approx(calls[0]["start_us"] + 20)
    # A call whose span lags its annotation by a pause of the host does not
    # move the others.
    lagged = fake_spans(starts)
    lagged[9] = lagged[9]._replace(start_ns=lagged[9].start_ns + 3_000_000)
    lag = program_spans.aligned(lagged, calls)
    assert lag[:9] == got[:9] and lag[10:] == got[10:]
    assert lag[9][1] == pytest.approx(got[9][1] + 3000) and lag[9][2] == got[9][2]
    # Spans that keep no steady distance to the calls line up with nothing.
    shuffled = [{"start_us": c["start_us"] + 700 * (i % 3), "end_us": 0} for i, c in enumerate(calls)]
    assert program_spans.aligned(fake_spans(starts), shuffled) is None
    assert program_spans.aligned(fake_spans(starts[:3]), calls) is None


def test_idle_split_names_the_innermost_span():
    spans = [("tsim.sample", 1000, 6000, {}), ("tsim.plan", 1100, 1900, {}), ("tsim.step", 2000, 3000, {}),
             ("tsim.to_host.wait", 3000, 5000, {})]
    rec = record(device=[("K1", 0, 2100.0, 2900.0, "kernel"), ("memcpy", 0, 3000.0, 4000.0, "memcpy"),
                         ("K2", 0, 7000.0, 10000.0, "kernel")])
    split = program_spans.idle_split(rec, spans, 0)
    # idle: 1000-2100 (middle in the plan), 2900-3000 (the step), 4000-7000
    # (middle 5500: the call, outside its children), 10000-11000 (between calls)
    assert split == {"tsim.sample": pytest.approx(3e-3), "tsim.plan": pytest.approx(1.1e-3),
                     "between calls": pytest.approx(1e-3), "tsim.step": pytest.approx(1e-4)}


def small_cell():
    cell = cells.load_cell("cult1.f32")
    return dataclasses.replace(cell, traffic=dataclasses.replace(cell.traffic, shots=1 << 13,
                                                                 batch_size=1 << 12, mesh=None))


@pytest.mark.parametrize("recorder", [True, False])
def test_a_traced_cpu_run_reads_the_spans_where_the_program_records_them(recorder, monkeypatch):
    from tsim_tpu_torch.utils import profiling

    monkeypatch.setattr(judge, "JUDGED_ROWS", 1 << 15)
    monkeypatch.setattr(judge, "MAX_OFFSET", 2)
    if not recorder:
        monkeypatch.delattr(profiling, "start")
    result, checks, _ = run.run_cell("cult1.f32", 2**33 + 7, 3.0, True, device="cpu", cell=small_cell(),
                                     started=time.perf_counter())
    assert result["correct"], checks
    names = {"host_move_ms_per_batch", "host_wait_ms_per_batch", "plan_ms_per_call"}
    if recorder:
        assert names <= set(result["metrics"])
        assert all(result["metrics"][n]["value"] > 0 for n in names)
    else:
        assert not names & set(result["metrics"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
