"""``f32_eval_roofline`` in a postselected cell: the f32 evaluation
kernels' share of their roofline at the rows the postselected ladder
must evaluate: those in which no directly drawn detector of the mask
fired (the prefilter's survivors).

Layer: evaluators and kernels. The reading of ``f32_eval_roofline.py``; it moves ``survivors_per_s``.
"""

from portbench import cells

UNIT = "%"
LAYER = "evaluators and kernels"
MOVES = "survivors_per_s"
SPAN = (0.1, 1.0)  # traced: the window after its first tenth (shares of the window)
read = cells.metric_reader("f32_eval_roofline").read
