"""Host time a call in planning its batches.

Layer: batch loop (``sampler.py`` ``_plan_batches``, with ``_card_rows``'s
read of each card's free memory, ``torch.cuda.mem_get_info``). The
program's ``tsim.plan`` spans inside the traced span, summed, over the
``tsim.sample`` spans there. Read from the program's span recorder
(``program_spans.py``), which loading this file turns on. Moves
``shots_per_s``.
"""

from portbench import program_spans

UNIT = "ms"
LAYER = "batch loop"
MOVES = "shots_per_s"
SPAN = (0.1, 1.0)  # traced: the window after its first tenth (shares of the window)
program_spans.record_spans()


def read(record: dict) -> float | None:
    return program_spans.ms_per(record, {"tsim.plan"}, {"tsim.sample"})
