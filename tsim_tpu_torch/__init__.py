"""tsim_tpu_torch: the PyTorch / CUDA port of tsim_tpu.

A :class:`Circuit` (Stim dialect plus tsim's non-Clifford gates) compiles on
the host with the port's own copy of ``tsim_tpu``'s compiler: the ZX
engine, with its C++ planner built by ``g++`` at first use, the stabilizer
decomposition and the term families, written as ``program_io``'s numpy
dataclasses. The samplers and state probabilities run on a torch device;
on an NVIDIA Hopper card the f32 sampling evaluator and the exact evaluator
run as hand-written CUDA kernels; a Clifford circuit's fully-direct
program is drawn on the host by the C++ Pauli-frame engine, as in
``tsim_tpu``. ``mesh=`` splits the shots over several cards
(``parallel/shard.py``). Circuits also give their detector error model, m2d converter
and diagrams. Programs can also come as data (``program_io``,
``models/exported.py``). It imports torch and numpy, never JAX.
"""

from .circuit import Circuit
from .models import cultivation_d3, distillation_d3, distillation_d5
from .program_io import ExportedProgram, load_npz, save_npz
from .sampler import CompiledDetectorSampler, CompiledMeasurementSampler, CompiledStateProbs

__version__ = "0.1.0"

__all__ = [
    "Circuit",
    "CompiledDetectorSampler",
    "CompiledMeasurementSampler",
    "CompiledStateProbs",
    "ExportedProgram",
    "cultivation_d3",
    "distillation_d3",
    "distillation_d5",
    "load_npz",
    "save_npz",
    "__version__",
]
