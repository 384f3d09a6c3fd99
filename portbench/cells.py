"""The benchmark's data, found by name: a cell of ``BENCHMARK.json`` names a
configuration (``configs/<name>.json`` and the circuit text it names) and a
traffic mix (``traffic/<name>.json``); a per-layer metric is
``metrics/<name>.py``. Nothing here imports the program."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Config:
    name: str
    source: str
    circuit_text: str
    num_detectors: int
    num_observables: int
    raw: dict


@dataclass
class Traffic:
    """One closed-loop caller's ``sample()`` call, repeated: ``shots`` rows a
    call, ``evaluation`` "f32" or "exact", ``batch_size`` (None: the
    program's default), ``mesh`` (None or "auto"), ``append_observables``,
    and ``postselection`` (None or "all_detectors")."""

    name: str
    evaluation: str
    shots: int
    batch_size: int | None
    mesh: str | None
    append_observables: bool
    postselection: str | None


@dataclass
class Cell:
    name: str
    chips: int
    config: Config
    traffic: Traffic
    end_to_end: list[dict]
    per_layer: list[dict]


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_config(name: str, base: Path = HERE / "configs") -> Config:
    raw = json.loads((base / f"{name}.json").read_text())
    text = (base / raw["circuit"]).read_text()
    return Config(name, raw["source"], text, int(raw["detectors"]), int(raw["observables"]), raw)


def load_traffic(name: str, base: Path = HERE / "traffic") -> Traffic:
    raw = json.loads((base / f"{name}.json").read_text())
    fields = {k: raw.get(k) for k in Traffic.__dataclass_fields__ if k != "name"}
    fields["shots"] = int(fields["shots"])
    fields["append_observables"] = bool(fields["append_observables"])
    if fields["evaluation"] not in ("f32", "exact"):
        raise ValueError(f"traffic {name}: evaluation {fields['evaluation']!r}")
    if fields["postselection"] not in (None, "all_detectors"):
        raise ValueError(f"traffic {name}: postselection {fields['postselection']!r}")
    return Traffic(name=name, **fields)


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench or benchmark()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=load_config(w["config"]),
        traffic=load_traffic(w["traffic"]),
        end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if reports(m, name)],
    )


def metric_reader(name: str, base: Path = HERE / "metrics") -> ModuleType:
    """``metrics/<name>.py``: its ``read(record)`` gives the metric's value,
    or None where the traced run holds nothing to read."""
    path = base / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
