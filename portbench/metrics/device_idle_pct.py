"""The card's idle share over the traced span.

Layer: device. 100 x (1 - the union of the card's kernel, copy and memset
intervals over the traced wall), by a copy of
``dev/torch_profile_d3.py::busy_union_us``. Moves ``shots_per_s``.
"""

from portbench import tracing

UNIT = "%"
LAYER = "device"
MOVES = "shots_per_s"
SPAN = (0.1, 1.0)  # traced: the window after its first tenth (shares of the window)


def read(record: dict) -> float | None:
    return tracing.idle_pct(record, record["devices"][0])
