"""The f32 evaluation kernels' share of their roofline.

Layer: evaluators and kernels (``compile/sample_eval.py``,
``kernels/sample_eval.py``, ``kernels/csrc/sample_eval.cu``). The sum over
the rungs of ``counts/work.py::f32_bound`` at the rows each evaluation
needs (a batch's rows), for as many evaluations as the traced span holds
launches of ``sample_eval*`` kernels over the rungs that launch one, over
those kernels' device time. Counted per rung, so it reads the same work
whichever kernel runs a rung. Moves ``shots_per_s``.
"""

from portbench import readers

UNIT = "%"
LAYER = "evaluators and kernels"
MOVES = "shots_per_s"
SPAN = (0.1, 1.0)  # traced: the window after its first tenth (shares of the window)


def read(record: dict) -> float | None:
    work = record.get("work") or {}
    if work.get("evaluation") != "f32":
        return None
    return readers.roofline_pct(record, readers.F32_EVAL, work["eval_least_ms"],
                                work["eval_launches"], record["evaluated_rows"])
