"""In-house Stim-dialect circuit engine (parser, instruction model, ops).

Replaces the reference's dependency on the Stim wheel for circuit text
parsing and structural manipulation (reference ``SURVEY.md`` section 2.1).
"""

from .circuit import Circuit
from .gates import GATE_DATA, GateData, gate_data, is_gate
from .instruction import CircuitInstruction, CircuitRepeatBlock
from .targets import (
    GateTarget,
    target_combiner,
    target_inv,
    target_qubit,
    target_rec,
    target_sweep_bit,
    target_x,
    target_y,
    target_z,
)

__all__ = [
    "Circuit",
    "CircuitInstruction",
    "CircuitRepeatBlock",
    "GateTarget",
    "GATE_DATA",
    "GateData",
    "gate_data",
    "is_gate",
    "target_combiner",
    "target_inv",
    "target_qubit",
    "target_rec",
    "target_sweep_bit",
    "target_x",
    "target_y",
    "target_z",
]
