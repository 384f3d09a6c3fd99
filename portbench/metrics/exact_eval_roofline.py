"""The exact evaluation kernels' share of their roofline.

Layer: evaluators and kernels (``compile/exact_eval.py``,
``kernels/exact_eval.py``, ``kernels/csrc/exact_eval.cu``). The sum over
the rungs of ``counts/work.py::exact_bound``, or ``approx_bound`` for a
rung with the approximate finisher, at a batch's rows, for as many
evaluations as the traced span holds launches of ``exact_*`` and
``approx_*`` kernels over the rungs that launch one, over those kernels'
device time. Moves ``shots_per_s``.
"""

from portbench import readers

UNIT = "%"
LAYER = "evaluators and kernels"
MOVES = "shots_per_s"
SPAN = (0.1, 1.0)  # traced: the window after its first tenth (shares of the window)


def read(record: dict) -> float | None:
    work = record.get("work") or {}
    if work.get("evaluation") != "exact":
        return None
    return readers.roofline_pct(record, readers.EXACT_EVAL, work["eval_least_ms"],
                                work["eval_launches"], record["evaluated_rows"])
