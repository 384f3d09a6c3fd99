"""The port's profiling hooks (``tsim_tpu_torch/utils/profiling.py``) on the CPU:
``trace`` writes a Chrome/Perfetto trace file that names the regions marked
with ``annotate``, around a real sampling call."""

import json

import numpy as np

from tsim_tpu_torch.models.exported import distillation_d3
from tsim_tpu_torch.utils.profiling import annotate, trace


def _trace_events(log_dir):
    files = list(log_dir.glob("*.pt.trace.json"))
    assert len(files) == 1, files
    return json.loads(files[0].read_text())["traceEvents"]


def test_trace_writes_a_file_naming_the_annotated_region(tmp_path):
    sampler = distillation_d3(p=0.05).compile_detector_sampler(seed=0, device="cpu")
    with trace(tmp_path / "d3"):
        with annotate("ladder"):
            out = sampler.sample(256, batch_size=128)
    assert out.shape == (256, 15) and out.dtype == np.bool_
    names = {e.get("name") for e in _trace_events(tmp_path / "d3")}
    assert "ladder" in names


def test_trace_prints_the_file_for_perfetto_and_keeps_it_after_a_failure(tmp_path, capsys):
    try:
        with trace(tmp_path, create_perfetto_link=True):
            with annotate("failing"):
                raise KeyError("inside the traced block")
    except KeyError:
        pass
    printed = capsys.readouterr().out
    assert "Perfetto" in printed and str(tmp_path) in printed
    assert "failing" in {e.get("name") for e in _trace_events(tmp_path)}
