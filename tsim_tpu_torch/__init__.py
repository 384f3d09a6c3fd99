"""tsim_tpu_torch: the PyTorch / CUDA port of tsim_tpu.

It samples compiled programs on a torch device and computes their state
probabilities; on an NVIDIA Hopper card the f32 sampling evaluator and the
exact evaluator run as hand-written CUDA kernels. The port has no circuit
compiler yet: programs come as data (``program_io``), exported from
``tsim_tpu``. It imports torch and numpy, never JAX.
"""

from .models import cultivation_d3, distillation_d3
from .program_io import ExportedProgram, load_npz, save_npz
from .sampler import CompiledDetectorSampler, CompiledMeasurementSampler, CompiledStateProbs

__all__ = [
    "CompiledDetectorSampler",
    "CompiledMeasurementSampler",
    "CompiledStateProbs",
    "ExportedProgram",
    "cultivation_d3",
    "distillation_d3",
    "load_npz",
    "save_npz",
]
