from .cultivation import cultivation_d3, cultivation_d3_grown, cultivation_logical
from .distillation import distillation_d3, distillation_d5, logical_distillation_circuit
from .surface_code import generated, rotated_surface_code_memory_z

__all__ = [
    "cultivation_d3",
    "cultivation_d3_grown",
    "cultivation_logical",
    "distillation_d3",
    "distillation_d5",
    "generated",
    "logical_distillation_circuit",
    "rotated_surface_code_memory_z",
]
