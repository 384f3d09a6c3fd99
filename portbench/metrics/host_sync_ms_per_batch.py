"""Host time inside blocking CUDA runtime calls a batch.

Layer: batch loop (``sampler.py`` ``_sample_batches``, ``_StepGraph``,
``_RowsToHost``). The profiler's host events of the runtime calls that wait
for the card (stream, event and device synchronisation; synchronous copies)
inside the traced span, summed, over the batches run there: one card's
share of a batch (a shard step, as the sampler's ``last_batch_steps``
counts them). Moves ``shots_per_s``.
"""

UNIT = "ms"
LAYER = "batch loop"
MOVES = "shots_per_s"
SPAN = (0.1, 1.0)  # traced: the window after its first tenth (shares of the window)
BLOCKING = {
    "cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize",
    "cudaMemcpy", "cudaMemcpy2D", "cudaMemset",
}


def read(record: dict) -> float | None:
    if not record.get("steps"):
        return None
    lo, hi = record["window_us"]
    waited = sum(min(e, hi) - max(s, lo) for name, _, s, e in record["host"]
                 if name in BLOCKING and e > lo and s < hi)
    return waited / 1e3 / record["steps"]
