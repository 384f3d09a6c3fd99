"""What the benchmark loads: no module whose top-level name, compared
whole, is ``jax``, ``jaxlib``, ``flax`` or ``tsim_tpu``; the reference
loads nothing of ``tsim_tpu_torch``; and a checkout without the program
gives no result."""

import json
import shutil
import subprocess
import sys

import pytest

from portbench import cells, run

ROOT = cells.ROOT


def python(code, cwd=ROOT, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True,
                          timeout=600, env=env)


def test_forbidden_names_are_compared_whole(monkeypatch):
    fake = {"numpy": None, "tsim_tpu_torch": None, "tsim_tpu_torch.sampler": None, "jax_like": None}
    monkeypatch.setattr(sys, "modules", fake)
    assert run.forbidden_modules() == []
    fake.update({"tsim_tpu.sampler": None, "jaxlib.xla_client": None})
    assert run.forbidden_modules() == ["jaxlib", "tsim_tpu"]


def test_the_reference_and_the_judge_load_no_program():
    code = ("import sys; sys.path.insert(0, '.');"
            "import portbench.reference.density, portbench.judge, portbench.cells, portbench.readers;"
            "from portbench.reference.density import output_distribution;"
            "from portbench import cells;"
            "output_distribution(cells.load_config('cultivation_d3_c1').circuit_text);"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'tsim_tpu', 'tsim_tpu_torch'}))")
    done = python(code)
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip() == "[]"


def test_a_cpu_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys, dataclasses; sys.path.insert(0, '.');"
            "from portbench import cells, judge, run;"
            "judge.JUDGED_ROWS = 1 << 14;"
            "cell = cells.load_cell('cult1.f32');"
            "cell = dataclasses.replace(cell, traffic=dataclasses.replace(cell.traffic, shots=4096));"
            "run.run_cell(cell.name, 3, 0.5, False, device='cpu', cell=cell);"
            "print(run.forbidden_modules())")
    done = python(code)
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_the_run_exits_without_a_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    done = subprocess.run([sys.executable, "portbench/run.py", "--workload", "cult1.f32", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert done.returncode != 0 and done.stdout.strip() == ""


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.');"
            "from portbench import run;"
            "print(run.run_cell('cult1.f32', 1, 0.5, False, device='cpu'))")
    done = python(code, cwd=tmp_path, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert done.returncode != 0
    assert "tsim_tpu_torch" in done.stderr
    assert not any(line.startswith("{") for line in done.stdout.splitlines())
    json.loads((tmp_path / "BENCHMARK.json").read_text())
