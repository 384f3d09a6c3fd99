"""Compilation-stage data types: the prepared sampling graph.

The compiled program's types are ``program_io``'s (``CompiledProgram``,
``CompiledComponent``, ``CompiledScalarGraphs`` and the term families):
the compiler writes them directly, so there is one set of program
dataclasses.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from ..zx.graph import ZXGraph


@dataclass(frozen=True)
class SamplingGraph:
    """Prepared (doubled, reduced, error-transformed) sampling graph.

    ``error_transform`` has shape (num_f, num_e): f = T @ e mod 2.
    """

    graph: "ZXGraph"
    error_transform: np.ndarray
    channel_probs: list[np.ndarray]
    num_outputs: int
    num_detectors: int
