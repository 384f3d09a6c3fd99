"""Host time a batch in moving rows into the call's result.

Layer: batch loop (``sampler.py`` ``_RowsToHost``: ``_move``'s copy from
pinned staging into the result, which touches its pages for the first
time; on the CPU, ``push``'s copy). The program's ``tsim.to_host.move``
spans inside the traced span, summed, over the ``tsim.step`` spans there
(one a shard and batch, as ``last_batch_steps`` counts them). Read from the
program's span recorder (``program_spans.py``), which loading this file
turns on. Moves ``shots_per_s``.
"""

from portbench import program_spans

UNIT = "ms"
LAYER = "batch loop"
MOVES = "shots_per_s"
SPAN = (0.1, 1.0)  # traced: the window after its first tenth (shares of the window)
program_spans.record_spans()


def read(record: dict) -> float | None:
    return program_spans.ms_per(record, {"tsim.to_host.move"}, {"tsim.step"})
