"""``step_mfu`` in a postselected cell: the whole batch step's share of the
card's peak, postselected: the noise of every row drawn, the evaluations
at the prefilter's survivors.

Layer: device. The reading of ``step_mfu.py``; it moves ``survivors_per_s``.
"""

from portbench import cells

UNIT = "%"
LAYER = "device"
MOVES = "survivors_per_s"
SPAN = (0.1, 1.0)  # traced: the window after its first tenth (shares of the window)
read = cells.metric_reader("step_mfu").read
