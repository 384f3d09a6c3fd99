"""User-facing quantum circuit: Stim-mirroring API with non-Clifford gates.

The tsim-compatible entry point (reference ``tsim/circuit.py``, copied from
``tsim_tpu/circuit.py``): circuits parse Stim-dialect text plus tsim
shorthand (T, TPP, R_X/Y/Z, U3, R_PAULI, R_XX/YY/ZZ, CCZ, CCX) and compile
on the host into measurement/detector samplers and state probabilities
that run on a torch device, and into its detector error model,
measurement-to-detection converter and diagrams. ``mesh=`` shards the
shots over several devices (``parallel/shard.py``): by default ("auto")
over every card when more than one is visible and no ``device`` is given.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Iterable, Literal, overload

from . import stim_core
from .core.graph_prep import build_sampling_graph
from .core.parse import parse_parametric_tag, parse_stim_circuit
from .core.tags import encode_t_tag
from .stim_core import Circuit as StimCircuit
from .stim_core.instruction import CircuitInstruction, CircuitRepeatBlock
from .utils.clifford import expand_clifford_rotations, is_clifford
from .utils.program_text import (
    controlled_gate_decomposition_lines,
    enriched_stim_error,
    format_angle,
    shorthand_to_stim,
    stim_to_shorthand,
)

if TYPE_CHECKING:
    from .sampler import CompiledDetectorSampler, CompiledMeasurementSampler, CompiledStateProbs

_PAULI_TARGET = {
    "X": stim_core.target_x,
    "Y": stim_core.target_y,
    "Z": stim_core.target_z,
}


def _single_angle(name: str, arg) -> float:
    if arg is None:
        raise ValueError(f"For {name} gates, an angle must be provided.")
    args = list(arg) if isinstance(arg, Iterable) else [arg]
    if len(args) != 1:
        raise ValueError(f"For {name} gates, a single angle must be provided.")
    return args[0]


def _two_distinct_qubits(name: str, targets) -> tuple[int, int]:
    qubits = list(targets) if isinstance(targets, Iterable) else [targets]
    if len(qubits) != 2:
        raise ValueError(f"For {name} gates, exactly two qubit targets are required.")
    q0, q1 = qubits
    if not isinstance(q0, int) or not isinstance(q1, int):
        raise ValueError(f"For {name} gates, both targets must be qubit indices.")
    if q0 == q1:
        raise ValueError(
            f"For {name} gates, the two target qubits must be distinct, got {q0} {q1}."
        )
    return q0, q1


def _pauli_product_targets(paulis: list[tuple[str, int]]):
    out = []
    for pauli, qubit in paulis:
        if out:
            out.append(stim_core.target_combiner())
        out.append(_PAULI_TARGET[pauli](qubit))
    return out


def _bare_qubit_targets(gate_name: str, targets) -> list[int]:
    if isinstance(targets, (int, stim_core.GateTarget)):
        items = [targets]
    else:
        items = list(targets)
    qubits: list[int] = []
    for t in items:
        if isinstance(t, int):
            qubits.append(t)
        elif isinstance(t, stim_core.GateTarget) and t.is_qubit_target:
            qubits.append(t.value)
        else:
            raise ValueError(f"{gate_name} only supports bare qubit targets.")
    return qubits


class Circuit:
    """Quantum circuit wrapping a Stim-dialect circuit with tsim extensions.

    >>> circuit = Circuit('''
    ...     H 0
    ...     T 0
    ...     CNOT 0 1
    ...     M 0 1
    ... ''')
    """

    __slots__ = ("_stim_circ",)

    def __init__(self, stim_program_text: str = ""):
        converted = shorthand_to_stim(stim_program_text)
        try:
            self._stim_circ = StimCircuit(converted)
        except ValueError as exc:
            raise enriched_stim_error(exc, converted) from None

    @classmethod
    def from_stim_program(cls, stim_circuit: StimCircuit) -> "Circuit":
        c = cls.__new__(cls)
        c._stim_circ = stim_circuit.copy()
        return c

    def append_from_stim_program_text(self, stim_program_text: str) -> None:
        converted = shorthand_to_stim(stim_program_text)
        try:
            self._stim_circ.append_from_stim_program_text(converted)
        except ValueError as exc:
            raise enriched_stim_error(exc, converted) from None

    def append(
        self,
        name,
        targets=(),
        arg=None,
        *,
        tag: str = "",
    ) -> None:
        """Append an operation (tsim gate names are rewritten to tagged Stim)."""
        if isinstance(name, str):
            if name in ("CCZ", "CCX"):
                if arg is not None:
                    raise ValueError(f"For {name} gates, no arguments are accepted.")
                qubits = _bare_qubit_targets(name, targets)
                if len(qubits) % 3 != 0:
                    raise ValueError(f"{name} expects qubit targets in groups of three.")
                self.append_from_stim_program_text(
                    "\n".join(
                        line
                        for i in range(0, len(qubits), 3)
                        for line in controlled_gate_decomposition_lines(
                            name, qubits[i], qubits[i + 1], qubits[i + 2], tag=tag
                        )
                    )
                )
                return
            if name == "TPP":
                name, tag = "SPP", encode_t_tag(tag)
            elif name == "TPP_DAG":
                name, tag = "SPP_DAG", encode_t_tag(tag)
            elif name == "T":
                name, tag = "S", encode_t_tag(tag)
            elif name == "T_DAG":
                name, tag = "S_DAG", encode_t_tag(tag)
            elif name in ("R_X", "R_Y", "R_Z"):
                angle = _single_angle(name, arg)
                tag = f"{name}(theta={angle}*pi)"
                name, arg = "I", None
            elif name == "U3":
                args = list(arg) if isinstance(arg, Iterable) else []
                if arg is None or len(args) != 3:
                    raise ValueError("For U3 gates, three rotation angles must be provided.")
                theta, phi, lam = args
                tag = f"U3(theta={theta}*pi, phi={phi}*pi, lambda={lam}*pi)"
                name, arg = "I", None
            elif name in ("R_XX", "R_YY", "R_ZZ"):
                alpha = _single_angle(name, arg)
                pauli = name[2]
                q0, q1 = _two_distinct_qubits(name, targets)
                targets = _pauli_product_targets([(pauli, q0), (pauli, q1)])
                tag = f"R_PAULI(theta={alpha}*pi)"
                name, arg = "SPP", None
            elif name == "R_PAULI":
                alpha = _single_angle(name, arg)
                tag = f"R_PAULI(theta={alpha}*pi)"
                name, arg = "SPP", None
            self._stim_circ.append(name, targets, arg, tag=tag)
        else:
            self._stim_circ.append(name)

    @classmethod
    def from_file(cls, filename: str) -> "Circuit":
        with open(filename, encoding="utf-8") as f:
            text = f.read()
        converted = shorthand_to_stim(text)
        try:
            stim_circ = StimCircuit(converted)
        except ValueError as exc:
            raise enriched_stim_error(exc, converted) from None
        return cls.from_stim_program(stim_circ)

    # ------------------------------------------------------------- plumbing
    def __repr__(self) -> str:
        return f"tsim_tpu_torch.Circuit('''\n{self!s}\n''')"

    def __str__(self) -> str:
        return stim_to_shorthand(str(self._stim_circ))

    def __len__(self) -> int:
        return len(self._stim_circ)

    def __eq__(self, other) -> bool:
        if isinstance(other, Circuit):
            return self._stim_circ == other._stim_circ
        return NotImplemented

    def __iadd__(self, other) -> "Circuit":
        self._stim_circ += other._stim_circ if isinstance(other, Circuit) else other
        return self

    def __add__(self, other) -> "Circuit":
        result = Circuit.from_stim_program(self._stim_circ.copy())
        result += other
        return result

    def __imul__(self, repetitions: int) -> "Circuit":
        self._stim_circ *= repetitions
        return self

    def __mul__(self, repetitions: int) -> "Circuit":
        return Circuit.from_stim_program(self._stim_circ * repetitions)

    __rmul__ = __mul__

    @overload
    def __getitem__(self, index_or_slice: int) -> Any: ...

    @overload
    def __getitem__(self, index_or_slice: slice) -> "Circuit": ...

    def __getitem__(self, index_or_slice):
        if isinstance(index_or_slice, int):
            return self._stim_circ[index_or_slice]
        if isinstance(index_or_slice, slice):
            return Circuit.from_stim_program(self._stim_circ[index_or_slice])
        raise TypeError(f"Invalid index or slice: {index_or_slice}")

    def approx_equals(self, other, *, atol: float) -> bool:
        if isinstance(other, Circuit):
            return self._stim_circ.approx_equals(other._stim_circ, atol=atol)
        if isinstance(other, StimCircuit):
            return self._stim_circ.approx_equals(other, atol=atol)
        return False

    # -------------------------------------------------------------- counters
    @property
    def num_measurements(self) -> int:
        return self._stim_circ.num_measurements

    @property
    def num_detectors(self) -> int:
        return self._stim_circ.num_detectors

    @property
    def num_observables(self) -> int:
        return self._stim_circ.num_observables

    @property
    def num_qubits(self) -> int:
        return self._stim_circ.num_qubits

    @property
    def num_ticks(self) -> int:
        return self._stim_circ.num_ticks

    # ------------------------------------------------------------- structure
    def pop(self, index: int = -1):
        return self._stim_circ.pop(index)

    def copy(self) -> "Circuit":
        return Circuit.from_stim_program(self._stim_circ.copy())

    def flattened(self) -> "Circuit":
        return Circuit.from_stim_program(self._stim_circ.flattened())

    def without_noise(self) -> "Circuit":
        return Circuit.from_stim_program(self._stim_circ.without_noise())

    def without_annotations(self) -> "Circuit":
        def strip(circuit: StimCircuit) -> StimCircuit:
            result = StimCircuit()
            for instr in circuit:
                if isinstance(instr, CircuitRepeatBlock):
                    result.append(
                        CircuitRepeatBlock(instr.repeat_count, strip(instr.body_copy()))
                    )
                    continue
                if instr.name in ("OBSERVABLE_INCLUDE", "DETECTOR"):
                    continue
                result.append(instr)
            return result

        return Circuit.from_stim_program(strip(self._stim_circ))

    def inverse(self) -> "Circuit":
        def fix_tags(circuit: StimCircuit) -> StimCircuit:
            result = StimCircuit()
            for instr in circuit:
                if isinstance(instr, CircuitRepeatBlock):
                    result.append(
                        CircuitRepeatBlock(instr.repeat_count, fix_tags(instr.body_copy()))
                    )
                    continue
                if instr.name == "I" and instr.tag:
                    parsed = parse_parametric_tag(instr)
                    if parsed is not None:
                        gate_name, params = parsed
                        targets = [t.value for t in instr.targets_copy()]
                        if gate_name == "U3":
                            # U3(t, p, l)^-1 = U3(-t, -l, -p)
                            theta = format_angle(-params["theta"])
                            phi = format_angle(-params["lambda"])
                            lam = format_angle(-params["phi"])
                            new_tag = f"U3(theta={theta}*pi, phi={phi}*pi, lambda={lam}*pi)"
                        else:
                            new_tag = f"{gate_name}(theta={format_angle(-params['theta'])}*pi)"
                        result.append("I", targets, instr.gate_args_copy() or None, tag=new_tag)
                        continue
                if instr.name in ("SPP", "SPP_DAG") and instr.tag:
                    parsed = parse_parametric_tag(instr)
                    if parsed is not None and parsed[0] == "R_PAULI":
                        new_tag = f"R_PAULI(theta={format_angle(-parsed[1]['theta'])}*pi)"
                        # Name already flipped by stim inverse; flip back and
                        # negate the angle instead.
                        flipped = "SPP" if instr.name == "SPP_DAG" else "SPP_DAG"
                        result.append(flipped, instr.targets_copy(), None, tag=new_tag)
                        continue
                result.append(instr)
            return result

        return Circuit.from_stim_program(fix_tags(self._stim_circ.inverse()))

    # --------------------------------------------------------------- queries
    @property
    def stim_circuit(self) -> StimCircuit:
        """Underlying circuit with half-pi rotations expanded to Cliffords."""
        return expand_clifford_rotations(self._stim_circ)

    @property
    def is_clifford(self) -> bool:
        return is_clifford(self._stim_circ)

    def to_tensor(self):
        built = parse_stim_circuit(self._stim_circ)
        g = built.graph.copy()
        inputs = [built.first_vertex[q] for q in sorted(built.first_vertex)]
        outputs = [built.last_vertex[q] for q in sorted(built.last_vertex)]
        g.set_inputs(inputs)
        g.set_outputs(outputs)
        return g.to_tensor()

    def to_matrix(self):
        built = parse_stim_circuit(self._stim_circ)
        g = built.graph.copy()
        inputs = [built.first_vertex[q] for q in sorted(built.first_vertex)]
        outputs = [built.last_vertex[q] for q in sorted(built.last_vertex)]
        g.set_inputs(inputs)
        g.set_outputs(outputs)
        return g.to_matrix()

    def tcount(self) -> int:
        from .zx.decompose import tcount

        built = parse_stim_circuit(self._stim_circ)
        return tcount(built.graph)

    def get_graph(self):
        return parse_stim_circuit(self._stim_circ).graph

    def get_sampling_graph(self, sample_detectors: bool = False):
        built = parse_stim_circuit(self._stim_circ)
        return build_sampling_graph(built, sample_detectors=sample_detectors)

    # ------------------------------------------------------------ compilation
    def compile_sampler(
        self, *, strategy: str = "cat5", seed: int | None = None, device=None,
        evaluation: str = "f32", per_term: bool | None = None, mesh="auto",
    ) -> "CompiledMeasurementSampler":
        """Compile on the host and sample measurements on ``device`` (the
        card when None; ``device="cpu"`` runs the kernels' plain versions),
        or over ``mesh`` (``sampler._resolve_mesh``)."""
        from .sampler import CompiledMeasurementSampler

        return CompiledMeasurementSampler(
            self, seed=seed, strategy=strategy, device=device, evaluation=evaluation,
            per_term=per_term, mesh=mesh,
        )

    def compile_detector_sampler(
        self, *, strategy: str = "cat5", seed: int | None = None, device=None,
        evaluation: str = "f32", per_term: bool | None = None, mesh="auto",
    ) -> "CompiledDetectorSampler":
        """Compile on the host and sample detectors and observables on
        ``device`` or over ``mesh``, as :meth:`compile_sampler`."""
        from .sampler import CompiledDetectorSampler

        return CompiledDetectorSampler(
            self, seed=seed, strategy=strategy, device=device, evaluation=evaluation,
            per_term=per_term, mesh=mesh,
        )

    def compile_state_probs(
        self,
        *,
        sample_detectors: bool = False,
        strategy: str = "cat5",
        seed: int | None = None,
        device=None,
        mesh="auto",
    ) -> "CompiledStateProbs":
        from .sampler import CompiledStateProbs

        return CompiledStateProbs(
            self, sample_detectors=sample_detectors, strategy=strategy, seed=seed,
            device=device, mesh=mesh,
        )

    def detector_error_model(
        self,
        *,
        allow_non_deterministic_observables: bool = True,
        decompose_errors: bool = False,
        flatten_loops: bool = False,
        allow_gauge_detectors: bool = False,
        approximate_disjoint_errors: bool = False,
        ignore_decomposition_failures: bool = False,
        block_decomposition_from_introducing_remnant_edges: bool = False,
    ):
        """Build the circuit's detector error model.

        ``allow_non_deterministic_observables`` defaults to True (matching
        reference ``noise/dem.py:11``): observables whose noiseless value is
        random get rewritten rather than rejected. Decomposition of error
        mechanisms requires it to be False (stim semantics).
        """
        from .noise.dem import get_detector_error_model

        return get_detector_error_model(
            self._stim_circ,
            allow_non_deterministic_observables=(
                allow_non_deterministic_observables
            ),
            decompose_errors=decompose_errors,
            flatten_loops=flatten_loops,
            allow_gauge_detectors=allow_gauge_detectors,
            approximate_disjoint_errors=approximate_disjoint_errors,
            ignore_decomposition_failures=ignore_decomposition_failures,
            block_decomposition_from_introducing_remnant_edges=(
                block_decomposition_from_introducing_remnant_edges
            ),
        )

    def compile_m2d_converter(self, *, skip_reference_sample: bool = False):
        from .stim_core.m2d import CompiledMeasurementsToDetectionEventsConverter

        return CompiledMeasurementsToDetectionEventsConverter(
            self._stim_circ, skip_reference_sample=skip_reference_sample
        )

    def diagram(self, type: str = "timeline-svg", **kwargs):
        from .utils.diagram import render_diagram

        return render_diagram(self, type, **kwargs)

    def cast_to_stim(self):
        return self._stim_circ
