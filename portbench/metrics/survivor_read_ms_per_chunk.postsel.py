"""Host time a postselected chunk in reading its survivor count.

Layer: batch loop (``sampler.py`` ``_sample_batches_with_postselection``:
the host's read of each chunk's count of rows the prefilter kept, which
waits for the chunk's noise draw and prefilter). The program's
``tsim.postsel.read`` spans inside the traced span, summed, over their
number. Read from the program's span recorder (``program_spans.py``),
which loading this file turns on. Moves ``survivors_per_s``.
"""

from portbench import program_spans

UNIT = "ms"
LAYER = "batch loop"
MOVES = "survivors_per_s"
SPAN = (0.1, 1.0)  # traced: the window after its first tenth (shares of the window)
program_spans.record_spans()


def read(record: dict) -> float | None:
    return program_spans.ms_per(record, {"tsim.postsel.read"}, {"tsim.postsel.read"})
