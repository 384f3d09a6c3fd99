from .distillation import distillation_d3

__all__ = ["distillation_d3"]
