"""Host time a batch in waiting for the card's rows and deviation.

Layer: batch loop (``sampler.py`` ``_RowsToHost._move``'s wait on a batch's
copy, ``_worst``'s read of the running norm deviation). The program's
``tsim.to_host.wait`` and ``tsim.deviation.read`` spans inside the traced
span, summed, over the ``tsim.step`` spans there: the program's own
counterpart of ``host_sync_ms_per_batch``, which sums the runtime calls by
name. Read from the program's span recorder (``program_spans.py``), which
loading this file turns on. Moves ``shots_per_s``.
"""

from portbench import program_spans

UNIT = "ms"
LAYER = "batch loop"
MOVES = "shots_per_s"
SPAN = (0.1, 1.0)  # traced: the window after its first tenth (shares of the window)
program_spans.record_spans()


def read(record: dict) -> float | None:
    return program_spans.ms_per(record, {"tsim.to_host.wait", "tsim.deviation.read"}, {"tsim.step"})
