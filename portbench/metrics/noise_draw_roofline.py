"""The noise-draw kernel's share of its roofline.

Layer: noise draw (``noise/device_channels.py``, ``kernels/noise_draw.py``,
``kernels/csrc/noise_draw.cu``). The least time of the rows drawn in the
traced span, (4C + F) bytes a row and the draw table once a launch over
HBM's 3.35 TB/s (``counts/work.py::noise_bound``), over the device time of
the ``noise_draw`` kernels there. Moves ``shots_per_s``.
"""

from portbench import readers

UNIT = "%"
LAYER = "noise draw"
MOVES = "shots_per_s"
SPAN = (0.1, 1.0)  # traced: the window after its first tenth (shares of the window)


def read(record: dict) -> float | None:
    work = record.get("work") or {}
    if "noise_least_ms" not in work:
        return None
    return readers.roofline_pct(record, readers.NOISE_DRAW, work["noise_least_ms"], 1, record["rows"])
