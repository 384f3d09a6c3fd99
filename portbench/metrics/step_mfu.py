"""The whole batch step's share of the cards' peak.

Layer: device. The least time of all the work the traced span did in the
noise draw and the evaluations (``noise_draw_roofline``'s and the
evaluation rooflines' counts, taken together), over the traced wall times
the cards used. It bounds every kernel's share from above, so it still
reads when a later change takes a kernel off the path. Moves
``shots_per_s``.
"""

from portbench import readers

UNIT = "%"
LAYER = "device"
MOVES = "shots_per_s"
SPAN = (0.1, 1.0)  # traced: the window after its first tenth (shares of the window)


def read(record: dict) -> float | None:
    return readers.step_pct(record)
