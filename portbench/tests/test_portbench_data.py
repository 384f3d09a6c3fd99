"""BENCHMARK.json, the configurations and the traffic mixes: found by name,
within the contract's limits, and the frozen circuits equal to what the
port's model builders generate."""

import json
import re

import pytest

from portbench import cells

BENCH = cells.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
GENERATORS = {
    "cultivation_d3_c1": dict(p=0.001, checks=1),
    "cultivation_d3_c2": dict(p=0.001, checks=2),
}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((cells.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_unique_and_well_formed(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metrics_well_formed():
    cell_names = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cell_names)) <= cell_names
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        for w in m.get("workloads", cell_names):
            moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
            assert w in moved.get("workloads", cell_names), (m["name"], w)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric():
    for w in BENCH["workloads"]:
        cell = cells.load_cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= 1


def test_configs_and_traffic_load_by_name():
    for c in BENCH["configs"]:
        cfg = cells.load_config(c["name"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert cfg.raw["reduced"] == c["reduced"] == []
        assert c["source"] == cfg.source and len(c["source"]) <= 200
        # The source names the generator that built the frozen text, and the
        # file lists where that departs from the paper.
        assert cfg.raw["generator"] in cfg.source and cfg.raw["departures_from_paper"]
    for w in BENCH["workloads"]:
        t = cells.load_traffic(w["traffic"])
        assert t.shots > 0 and t.evaluation in ("f32", "exact")


def test_a_traffic_file_with_an_unknown_evaluation_is_refused(tmp_path):
    (tmp_path / "bad.json").write_text(json.dumps({
        "evaluation": "f16", "shots": 8, "batch_size": None, "mesh": None,
        "append_observables": False, "postselection": None}))
    with pytest.raises(ValueError):
        cells.load_traffic("bad", base=tmp_path)


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_frozen_circuits_equal_the_model_builders(name):
    from tsim_tpu_torch.circuit import Circuit
    from tsim_tpu_torch.models import cultivation_d3

    cfg = cells.load_config(name)
    built = cultivation_d3(**GENERATORS[name])
    assert cfg.circuit_text.strip() == str(built).strip()
    assert Circuit(cfg.circuit_text) == built
    assert (cfg.num_detectors, cfg.num_observables) == (built.num_detectors, built.num_observables)


def test_every_per_layer_metric_has_a_reader_that_agrees_with_benchmark_json():
    for m in BENCH["per_layer"]:
        reader = cells.metric_reader(m["name"])
        assert (reader.UNIT, reader.LAYER, reader.MOVES) == (m["unit"], m["layer"], m["moves"])
        assert callable(reader.read)
        assert 0 <= reader.SPAN[0] < reader.SPAN[1] <= 1


def test_every_file_of_the_benchmark_is_used():
    used = {f"{c['name']}.json" for c in BENCH["configs"]}
    used |= {cells.load_config(c["name"]).raw["circuit"] for c in BENCH["configs"]}
    assert {f.name for f in (cells.HERE / "configs").iterdir()} == used
    traffic = {f"{w['traffic']}.json" for w in BENCH["workloads"]}
    assert {f.name for f in (cells.HERE / "traffic").iterdir()} == traffic
    metrics = {f"{m['name']}.py" for m in BENCH["per_layer"]}
    assert {f.name for f in (cells.HERE / "metrics").glob("*.py")} == metrics
