"""``device_idle_pct`` in a postselected cell: the card's idle share over
the traced span of a postselected cell.

Layer: device. The reading of ``device_idle_pct.py``; it moves ``survivors_per_s``.
"""

from portbench import cells

UNIT = "%"
LAYER = "device"
MOVES = "survivors_per_s"
SPAN = (0.1, 1.0)  # traced: the window after its first tenth (shares of the window)
read = cells.metric_reader("device_idle_pct").read
