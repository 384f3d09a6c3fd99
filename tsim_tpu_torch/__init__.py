"""tsim_tpu_torch: the PyTorch / CUDA port of tsim_tpu.

It samples compiled programs on a torch device; on an NVIDIA Hopper card
the f32 sampling evaluator runs as a hand-written CUDA kernel. The port
has no circuit compiler yet: programs come as data (``program_io``),
exported from ``tsim_tpu``. It imports torch and numpy, never JAX.
"""

from .program_io import ExportedProgram, load_npz, save_npz
from .sampler import CompiledDetectorSampler, CompiledMeasurementSampler

__all__ = [
    "CompiledDetectorSampler",
    "CompiledMeasurementSampler",
    "ExportedProgram",
    "load_npz",
    "save_npz",
]
