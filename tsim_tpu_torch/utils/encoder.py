"""Transversal QEC encoders for code-level benchmark circuits.

Feature parity with the reference's encoder utilities (reference
``src/tsim/utils/encoder.py:82,176,211``): rewrite a logical program into an
encoded physical circuit by fanning each qubit target out over code blocks,
replicating DETECTOR lines per stabilizer generator and OBSERVABLE_INCLUDE
lines per logical support. Unlike the reference, Pauli-product instructions
(MPP/SPP/TPP) keep their Pauli types and combiner structure when broadcast.
"""

from __future__ import annotations

import dataclasses

from .. import stim_core
from ..circuit import Circuit
from ..stim_core import Circuit as StimCircuit

_PAULI_TARGET = {
    "X": stim_core.target_x,
    "Y": stim_core.target_y,
    "Z": stim_core.target_z,
}


def _pauli_product_at(group, qubit_of) -> list:
    """One combiner-joined Pauli product with every qubit relocated."""
    prod: list = []
    for t in group:
        if prod:
            prod.append(stim_core.target_combiner())
        prod.append(
            _PAULI_TARGET[t.pauli_type](
                qubit_of(t.value), invert=t.is_inverted_result_target
            )
        )
    return prod


@dataclasses.dataclass(frozen=True)
class CodeSpec:
    """Static description of a stabilizer code for transversal encoding.

    ``block_size`` physical qubits per logical qubit; ``injection_slot`` is
    the in-block index where the logical state is prepared before running
    ``encoding_text``; ``stabilizers``/``logical_supports`` give the in-block
    measurement-slot fanouts for DETECTOR / OBSERVABLE_INCLUDE lines.
    """

    block_size: int
    injection_slot: int
    encoding_text: str | None
    stabilizers: tuple[tuple[int, ...], ...]
    logical_supports: tuple[tuple[int, ...], ...]


class TransversalEncoder:
    """Broadcasts logical programs across fixed-size code blocks.

    ``initialize`` prepares each logical qubit on one physical slot and runs
    the code's encoding circuit on every used block; ``encode_transversally``
    replaces each logical gate with its transversal physical version.
    """

    def __init__(self, spec: CodeSpec):
        self.spec = spec
        self.circuit = Circuit()
        self.used_qubits: set[int] = set()

    @property
    def n(self) -> int:
        return self.spec.block_size

    # -- public API ---------------------------------------------------------

    def initialize(
        self, program_text: str, encoding_program_text: str | None = None
    ) -> None:
        """Run logical state prep on one slot per block, then encode each block."""
        encoding = encoding_program_text or self.spec.encoding_text
        if not encoding:
            raise ValueError("Encoding program text is required")
        size = self.spec.block_size
        self._splice(
            program_text, [self.spec.injection_slot], stride=size, track=True
        )
        self._splice(encoding, [size * q for q in sorted(self.used_qubits)], stride=1)

    def encode_transversally(self, program_text: str) -> None:
        """Apply each logical gate to every physical qubit of its block(s)."""
        size = self.spec.block_size
        self._splice(program_text, list(range(size)), stride=size)

    def diagram(self, **kwargs):
        """Timeline SVG of the encoded physical circuit."""
        return self.circuit.diagram("timeline-svg", **kwargs)

    # -- rewriting core -----------------------------------------------------

    def _annotation_supports(self, name: str):
        """Rec-offset fanout sets for annotation instructions, else None."""
        if name == "DETECTOR" and self.spec.stabilizers:
            return self.spec.stabilizers
        if name == "OBSERVABLE_INCLUDE" and self.spec.logical_supports:
            return self.spec.logical_supports
        return None

    def _splice(
        self,
        program_text: str,
        offsets: list[int],
        *,
        stride: int,
        track: bool = False,
    ) -> None:
        """Broadcast ``program_text`` over code blocks and append the result.

        Qubit target q fans out to ``{q*stride + o for o in offsets}``.
        Measurement-record lookbacks in annotations fan out the same way,
        once per support set from ``_annotation_supports``. With ``track``,
        record which logical qubits the program touches (used by
        ``initialize`` to know which blocks need encoding).
        """
        out = StimCircuit()
        for ins in Circuit(program_text)._stim_circ.flattened():
            groups = ins.target_groups()
            if not groups:
                out.append(ins)
                continue
            if track:
                self.used_qubits.update(t.value for grp in groups for t in grp)
            name, tag = ins.name, ins.tag
            args = ins.gate_args_copy() or None
            supports = self._annotation_supports(name)
            if supports is not None:
                recs = [t.value for grp in groups for t in grp]
                for members in supports:
                    fanned = [
                        stim_core.target_rec(r * stride + m)
                        for r in recs
                        for m in members
                    ]
                    out.append(name, fanned, args, tag=tag)
            elif any(t.is_pauli_target for grp in groups for t in grp):
                prods: list = []
                for grp in groups:
                    for off in offsets:
                        prods.extend(
                            _pauli_product_at(grp, lambda q: q * stride + off)
                        )
                out.append(name, prods, args, tag=tag)
            else:
                fanned = [
                    t.value * stride + off
                    for grp in groups
                    for off in offsets
                    for t in grp
                ]
                out.append(name, fanned, args, tag=tag)
        self.circuit.append_from_stim_program_text(str(out))


class SteaneEncoder(TransversalEncoder):
    """[[7,1,3]] Steane code transversal encoder."""

    def __init__(self):
        encoding_program = """
        R 0 1 2 3 4 5
        TICK
        SQRT_Y_DAG 0 1 2 3 4 5
        TICK
        CZ 1 2 3 4 5 6
        TICK
        SQRT_Y 6
        TICK
        CZ 0 3 2 5 4 6
        TICK
        SQRT_Y 2 3 4 5 6
        TICK
        CZ 0 1 2 3 4 5
        TICK
        SQRT_Y 1 2 4
        TICK
        X 3
        Z 5 1
        TICK
        """
        spec = CodeSpec(
            block_size=7,
            injection_slot=6,
            encoding_text=encoding_program,
            stabilizers=((0, 1, 2, 3), (1, 2, 4, 5), (2, 3, 4, 6)),
            logical_supports=((0, 1, 5),),
        )
        super().__init__(spec)


class ColorEncoder5(TransversalEncoder):
    """[[17,1,5]] 2D color code transversal encoder."""

    def __init__(self):
        encoding_program = """
        R 0 1 2 3 4 5 6 8 9 10 11 12 13 14 15 16
        SQRT_Y 0 1 2 3 4 5 6 8 9 10 11 12 13 14 15 16
        TICK
        CZ 1 3 7 10 12 14 13 16
        TICK
        SQRT_Y_DAG 7 16
        TICK
        CZ 4 7 8 10 11 14 15 16
        TICK
        SQRT_Y_DAG 4 10 14 16
        TICK
        CZ 2 4 6 8 7 9 10 13
        CZ 14 16
        TICK
        SQRT_Y 3 6 9 10 12 13
        TICK
        CZ 0 2 3 6 5 8 10 12 11 13
        TICK
        SQRT_Y 1 2 3 4 6 7 8 9 11 12 14
        TICK
        CZ 0 1 2 3 4 5 6 7 8 9 12 15
        TICK
        SQRT_Y_DAG 0 2 5 6 8 10 12
        X 14 7 5 2 1 4
        Z 11 6 4 2
        """
        spec = CodeSpec(
            block_size=17,
            injection_slot=7,
            encoding_text=encoding_program,
            stabilizers=(
                (0, 1, 2, 3),
                (0, 2, 4, 5),
                (4, 5, 6, 7),
                (6, 7, 8, 9),
                (11, 13, 14, 16),
                (10, 11, 12, 14),
                (12, 14, 15, 16),
                (2, 3, 5, 6, 8, 10, 11, 13),
            ),
            logical_supports=((1, 3, 10, 12, 15),),
        )
        super().__init__(spec)
