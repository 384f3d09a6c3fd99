from .cultivation import cultivation_d3
from .distillation import distillation_d3

__all__ = ["cultivation_d3", "distillation_d3"]
