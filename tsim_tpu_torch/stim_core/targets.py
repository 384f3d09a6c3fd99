"""Gate targets for the Stim dialect (in-house stim.GateTarget equivalent)."""

from __future__ import annotations

from dataclasses import dataclass

QUBIT = 0
REC = 1
SWEEP = 2
PAULI_X = 3
PAULI_Y = 4
PAULI_Z = 5
COMBINER = 6


@dataclass(frozen=True)
class GateTarget:
    """A single instruction target.

    ``value`` is the qubit index (qubit/pauli targets), the negative lookback
    for ``rec[-k]`` targets (stored negative, resolved by consumers), or the
    sweep-bit index.
    """

    value: int = 0
    kind: int = QUBIT
    invert: bool = False

    # ---- stim-compatible predicates ----
    @property
    def is_qubit_target(self) -> bool:
        return self.kind == QUBIT

    @property
    def is_measurement_record_target(self) -> bool:
        return self.kind == REC

    @property
    def is_sweep_bit_target(self) -> bool:
        return self.kind == SWEEP

    @property
    def is_combiner(self) -> bool:
        return self.kind == COMBINER

    @property
    def is_x_target(self) -> bool:
        return self.kind == PAULI_X

    @property
    def is_y_target(self) -> bool:
        return self.kind == PAULI_Y

    @property
    def is_z_target(self) -> bool:
        return self.kind == PAULI_Z

    @property
    def is_pauli_target(self) -> bool:
        return self.kind in (PAULI_X, PAULI_Y, PAULI_Z)

    @property
    def is_inverted_result_target(self) -> bool:
        return self.invert

    @property
    def pauli_type(self) -> str:
        return {PAULI_X: "X", PAULI_Y: "Y", PAULI_Z: "Z"}[self.kind]

    def __str__(self) -> str:
        bang = "!" if self.invert else ""
        if self.kind == QUBIT:
            return f"{bang}{self.value}"
        if self.kind == REC:
            return f"rec[{self.value}]"
        if self.kind == SWEEP:
            return f"sweep[{self.value}]"
        if self.kind == COMBINER:
            return "*"
        return f"{bang}{self.pauli_type}{self.value}"

    def __repr__(self) -> str:
        return f"GateTarget({self!s})"


def target_qubit(q: int, invert: bool = False) -> GateTarget:
    return GateTarget(q, QUBIT, invert)


def target_rec(lookback: int) -> GateTarget:
    if lookback >= 0:
        raise ValueError("rec targets must use negative lookback")
    return GateTarget(lookback, REC)


def target_sweep_bit(i: int) -> GateTarget:
    return GateTarget(i, SWEEP)


def target_x(q: int, invert: bool = False) -> GateTarget:
    return GateTarget(q, PAULI_X, invert)


def target_y(q: int, invert: bool = False) -> GateTarget:
    return GateTarget(q, PAULI_Y, invert)


def target_z(q: int, invert: bool = False) -> GateTarget:
    return GateTarget(q, PAULI_Z, invert)


def target_combiner() -> GateTarget:
    return GateTarget(0, COMBINER)


def target_inv(q: int) -> GateTarget:
    return GateTarget(q, QUBIT, True)
