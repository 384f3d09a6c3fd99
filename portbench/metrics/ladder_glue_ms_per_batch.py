"""Device time a batch of the ladder's glue.

Layer: ladder (``sampler.py`` ``_sample_component``,
``sample_program_with_deviation``). The device time in the traced span of
every kernel that is neither an evaluation kernel (``sample_eval*``,
``exact_*``, ``approx_*``) nor ``noise_draw`` nor a copy or memset: the
concatenations, gathers, compares and draws' uniforms, over the batches run
there (shard steps). Moves ``shots_per_s``.
"""

from portbench import readers

UNIT = "ms"
LAYER = "ladder"
MOVES = "shots_per_s"
SPAN = (0.1, 1.0)  # traced: the window after its first tenth (shares of the window)


def read(record: dict) -> float | None:
    if not record.get("steps"):
        return None
    lo, hi = record["window_us"]
    glue = [e for e in record["device"]
            if e[4] == "kernel" and lo <= e[2] and e[3] <= hi
            and not any(readers.matches(p, e[0])
                        for p in (readers.F32_EVAL, readers.EXACT_EVAL, readers.NOISE_DRAW))]
    if not glue:
        return None
    return readers.device_ms(glue) / record["steps"]
