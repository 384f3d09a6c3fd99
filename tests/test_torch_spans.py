"""The port's span recorder (``tsim_tpu_torch/utils/profiling.py``) on the CPU.

The spans of a call form a tree that matches what the call did: one
``tsim.sample`` and one ``tsim.plan``, a ``tsim.step`` for every batch step
the sampler counts, rows that add up to the shots, survivors that add up to
the rows the prefilter kept, a ``tsim.capture`` where a step is captured.
Recording changes no bit of the samples, records nothing when off, and
stamps spans on the clock of ``torch.profiler``'s host events, which a test
here holds to the profiler's own events.
"""

import json
import time

import numpy as np
import pytest
import torch

from tests.test_torch_batch_loop import _EagerStepGraph
from tsim_tpu_torch import sampler as port_sampler
from tsim_tpu_torch.circuit import Circuit
from tsim_tpu_torch.models.exported import cultivation_d3, distillation_d3
from tsim_tpu_torch.utils import profiling

D3 = distillation_d3(p=0.05)
CULT1 = cultivation_d3(p=0.001, checks=1)


@pytest.fixture(autouse=True)
def recorder_off():
    profiling.stop()
    yield
    profiling.stop()


def recorded(fn):
    """(fn's result, the spans it recorded)."""
    profiling.start()
    try:
        out = fn()
    finally:
        spans = profiling.stop()
    return out, spans


def named(spans, name):
    return [s for s in spans if s.name == name]


def assert_nested(spans):
    """Each span lies inside its parent, takes the call of its parent (a
    ``tsim.sample`` is its own call), and the ids are distinct."""
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (p, s)
            assert s.call == (p.call or (s.id if s.name == profiling.CALL else 0))
        else:
            assert s.call == (s.id if s.name == profiling.CALL else 0)


def mesh_kwargs(mesh):
    return {"device": "cpu"} if mesh is None else {"mesh": port_sampler.ShotMesh(["cpu"] * mesh)}


@pytest.mark.parametrize("mesh", [None, 2])
def test_a_multi_batch_call_is_one_tree(mesh):
    sampler = D3.compile_detector_sampler(seed=3, **mesh_kwargs(mesh))
    shots = 5 * 64 + 17
    out, spans = recorded(lambda: sampler.sample(shots, batch_size=64, append_observables=True))
    assert out.shape[0] == shots
    (call,) = named(spans, "tsim.sample")
    (plan,) = named(spans, "tsim.plan")
    assert call.counts == {"shots": shots} and call.parent == 0
    assert plan.counts == {"mem_reads": 0, "batch_rows": 64, "shards": len(sampler._shards)}
    steps = named(spans, "tsim.step")
    assert len(steps) == sum(sampler.last_batch_steps.values())
    assert {s.counts["action"] for s in steps} == {"eager"}
    assert sum(s.counts["rows"] for s in steps) == shots
    moves = named(spans, "tsim.to_host.move")
    assert sum(s.counts["rows"] for s in moves) == shots
    assert sum(s.counts["bytes"] for s in moves) == out.size
    assert len(named(spans, "tsim.deviation.read")) == 1
    assert all(s.call == call.id for s in spans)
    assert {s.parent for s in spans if s is not call} == {call.id}
    assert_nested(spans)


def test_the_plan_counts_its_reads_of_free_memory(monkeypatch):
    sampler = D3.compile_detector_sampler(seed=3, device="cpu")
    _, spans = recorded(lambda: sampler.sample(100))
    (plan,) = named(spans, "tsim.plan")
    # The CPU's budget reads no card's memory; the default batch is one.
    assert plan.counts == {"mem_reads": 0, "batch_rows": 100, "shards": 1}
    monkeypatch.setattr(port_sampler._CompiledSamplerBase, "_card_rows",
                        lambda self, postselected=False: profiling.note(mem_reads=1) or 50)
    _, spans = recorded(lambda: sampler.sample(100))
    (plan,) = named(spans, "tsim.plan")
    assert plan.counts == {"mem_reads": 1, "batch_rows": 50, "shards": 1}
    assert len(named(spans, "tsim.step")) == 2


@pytest.mark.parametrize("mesh", [None, 2])
def test_a_postselected_call_counts_its_survivors(mesh):
    sampler = CULT1.compile_detector_sampler(seed=5, **mesh_kwargs(mesh))
    mask = sampler._direct_detector_mask.copy()
    shots = 3 * 1024 + 100
    out, spans = recorded(lambda: sampler.sample(shots, batch_size=1024, postselection_mask=mask))
    clear = int(np.count_nonzero(~out[:, mask].any(axis=1)))
    reads = named(spans, "tsim.postsel.read")
    assert 0 < clear < shots
    assert sum(s.counts["survivors"] for s in reads) == clear
    draws = named(spans, "tsim.postsel.draw")
    assert len(draws) == len(reads) and sum(s.counts["rows"] for s in draws) == shots
    assert sum(s.counts["rows"] for s in named(spans, "tsim.postsel.evaluate")) == clear
    assert sum(s.counts["rows"] for s in named(spans, "tsim.to_host.move")) == shots
    assert len(named(spans, "tsim.sample")) == 1 and len(named(spans, "tsim.plan")) == 1
    assert_nested(spans)


@pytest.mark.parametrize("postselected", [False, True])
def test_recording_changes_no_bit(postselected):
    kwargs = {"batch_size": 512, "append_observables": True}
    rows = []
    for on in (False, True, False):
        sampler = CULT1.compile_detector_sampler(seed=11, device="cpu")
        if postselected:
            kwargs["postselection_mask"] = np.ones(sampler._num_detectors, bool)
        profiling.start()
        if not on:
            profiling.stop()
        try:
            rows.append(sampler.sample(2000, **kwargs))
        finally:
            spans = profiling.stop()
        assert bool(spans) == on
    np.testing.assert_array_equal(rows[0], rows[1])
    np.testing.assert_array_equal(rows[2], rows[1])


def test_off_the_recorder_reads_no_clock_and_records_nothing(monkeypatch):
    profiling.start()
    recorded_list = profiling.stop()
    sampler = D3.compile_detector_sampler(seed=3, device="cpu")

    def no_clock():
        raise AssertionError("a span read the clock while recording was off")

    monkeypatch.setattr(profiling.time, "time_ns", no_clock)
    assert not profiling.recording()
    with profiling.span("tsim.step", rows=1) as s:
        profiling.note(rows=2)
    assert s is None and profiling.span("a") is profiling.span("b")
    monkeypatch.undo()
    sampler.sample(300, batch_size=64)
    assert recorded_list == [] and profiling.stop() is recorded_list


def test_every_sampling_entry_point_opens_a_call():
    detector = D3.compile_detector_sampler(seed=1, device="cpu")
    measurement = Circuit("H 0\nT 0\nH 0\nM 0").compile_sampler(seed=1, device="cpu")
    _, spans = recorded(lambda: (detector.sample(10), measurement.sample(7, batch_size=4)))
    calls = named(spans, "tsim.sample")
    assert [c.counts["shots"] for c in calls] == [10, 7]
    assert len(named(spans, "tsim.step")) == 1 + 2
    assert_nested(spans)


def test_state_probabilities_open_a_call():
    probs = D3.compile_state_probs(seed=0, device="cpu")
    state = np.zeros(probs._program.num_outputs, bool)
    _, spans = recorded(lambda: probs.probability_of(state, batch_size=16))
    (call,) = named(spans, "tsim.sample")
    assert call.counts == {"shots": 16}


def test_a_compile_is_a_span_that_says_whether_the_cache_held_it(tmp_path, monkeypatch):
    from tsim_tpu_torch.compile import aot_cache

    monkeypatch.setattr(aot_cache, "_memory", {})
    monkeypatch.setenv("TSIM_TPU_COMPILE_CACHE_DIR", str(tmp_path))
    circuit = Circuit("H 0\nT 0\nH 0\nM 0")
    _, spans = recorded(lambda: [circuit.compile_sampler(seed=1, device="cpu") for _ in range(2)])
    assert [s.counts for s in named(spans, "tsim.compile")] == [{"cache_hit": False}, {"cache_hit": True}]


@pytest.mark.parametrize("evaluation", ["f32", "exact"])
def test_the_tables_build_is_a_span_that_counts_the_node_phase_fold(evaluation):
    """Set-up builds the evaluator tables inside ``tsim.tables``, which gives
    each exact rung's graphs, live node-phase terms and those that
    exact_wide's fold takes: in exact mode every rung of 2-check
    cultivation, and of d3 the one rung without approximate floatfactors; in
    f32 mode none (every rung takes the f32 tables)."""
    cult2 = cultivation_d3(p=0.001, checks=2)
    _, spans = recorded(lambda: cult2.compile_detector_sampler(seed=2, device="cpu", evaluation=evaluation))
    (tables,) = named(spans, "tsim.tables")
    exact = evaluation == "exact"
    assert tables.counts == {
        "evaluation": evaluation,
        "exact_rung_graphs": [1, 4, 168, 205, 235, 32, 32, 32, 32, 307] if exact else [],
        "live_node_terms": [0, 6, 1005, 1068, 1897, 143, 175, 207, 239, 3190] if exact else [],
        "folded_node_terms": [0, 6, 964, 1032, 1781, 143, 175, 207, 239, 2672] if exact else [],
    }
    _, spans = recorded(lambda: D3.compile_detector_sampler(seed=2, device="cpu", evaluation=evaluation))
    (d3,) = named(spans, "tsim.tables")
    assert d3.counts["exact_rung_graphs"] == ([1] if exact else [])
    assert d3.counts["folded_node_terms"] == ([0] if exact else [])


def test_a_capture_is_a_span_inside_its_step(monkeypatch):
    monkeypatch.setattr(port_sampler, "_graphs_on", lambda device: True)
    monkeypatch.setattr(port_sampler, "_StepGraph", _EagerStepGraph)
    sampler = D3.compile_detector_sampler(seed=16, device="cpu")
    _, spans = recorded(lambda: sampler.sample(4 * 64, batch_size=64))
    assert [s.counts["action"] for s in named(spans, "tsim.step")] == ["eager", "capture", "replay", "replay"]
    (capture,) = named(spans, "tsim.capture")
    step = next(s for s in spans if s.id == capture.parent)
    assert step.name == "tsim.step" and step.counts["action"] == "capture"
    assert capture.counts == {"rows": 64}
    assert_nested(spans)


def _kineto_events(prof, name):
    return [e for e in prof.profiler.kineto_results.events() if e.name() == name]


def test_span_clock_is_the_profilers():
    """A ``record_function`` opened inside a span: the profiler's event for
    it lies inside the span and starts within 200 us of it. A profiler that
    stamps its events on another clock fails here."""
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        for _ in range(2):  # the first ones pay for the profiler's set-up
            with torch.profiler.record_function("warm"):
                torch.ones(64).sum()
        profiling.start()
        for _ in range(3):
            with profiling.span("outer"):
                with torch.profiler.record_function("inner"):
                    torch.ones(64).sum()
    finally:
        spans = profiling.stop()
        prof.stop()
    events = sorted(_kineto_events(prof, "inner"), key=lambda e: e.start_ns())
    assert len(events) == len(spans) == 3
    for s, e in zip(sorted(spans, key=lambda s: s.start_ns), events):
        where = (s.start_ns, e.start_ns(), e.end_ns(), s.end_ns)
        assert s.start_ns <= e.start_ns() and e.end_ns() <= s.end_ns, where
        assert e.start_ns() - s.start_ns < 200_000, where


def test_trace_writes_the_spans_on_the_files_time_base(tmp_path):
    sampler = D3.compile_detector_sampler(seed=0, device="cpu")
    with profiling.trace(tmp_path):
        with profiling.annotate("mine"):
            with torch.profiler.record_function("inner"):
                sampler.sample(128, batch_size=64)
    assert not profiling.recording()
    (path,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "tsim"}
    assert {"mine", "tsim.sample", "tsim.plan", "tsim.step", "tsim.to_host.move"} <= set(spans)
    inner = next(e for e in events if e.get("name") == "inner" and e.get("cat") != "tsim")
    mine, call = spans["mine"], spans["tsim.sample"]
    assert mine["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= mine["ts"] + mine["dur"]
    assert inner["ts"] <= call["ts"] and call["args"]["shots"] == 128
    assert spans["tsim.step"]["args"]["device"] == "cpu"


def test_spans_of_a_trace_outside_it_are_left_out(tmp_path):
    profiling.start()
    with profiling.span("before"):
        pass
    with profiling.trace(tmp_path):
        with profiling.span("during"):
            pass
    assert profiling.recording()
    names = [s.name for s in profiling.stop()]
    (path,) = tmp_path.glob("*.pt.trace.json")
    written = {e["name"] for e in json.loads(path.read_text())["traceEvents"] if e.get("cat") == "tsim"}
    assert names == ["before", "during"] and written == {"during"}


def test_an_exception_closes_the_span():
    profiling.start()
    with pytest.raises(KeyError):
        with profiling.span("outer"):
            with profiling.span("inner", rows=3):
                raise KeyError("inside")
    with profiling.span("after"):
        time.sleep(0)
    spans = profiling.stop()
    assert [s.name for s in spans] == ["inner", "outer", "after"]
    assert spans[0].parent == spans[1].id and spans[2].parent == 0
