"""A plain parser of the stim circuit text the benchmark's configurations use.

It knows the instructions of a flat circuit (no ``REPEAT`` blocks): the
Clifford and T gates, resets, Z- and X-basis measurements, Pauli-product
measurements (``MPP``), Pauli noise channels, ``DETECTOR`` and
``OBSERVABLE_INCLUDE``. Anything else raises, so that a configuration the
simulator cannot follow is refused rather than misread.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

ONE_QUBIT_GATES = {
    "I", "X", "Y", "Z", "H", "S", "S_DAG", "T", "T_DAG",
    "SQRT_X", "SQRT_X_DAG", "SQRT_Y", "SQRT_Y_DAG",
}
TWO_QUBIT_GATES = {"CX", "CNOT", "CZ", "SWAP"}
RESETS = {"R": "Z", "RZ": "Z", "RX": "X"}
MEASUREMENTS = {"M": "Z", "MZ": "Z", "MX": "X"}
ONE_QUBIT_NOISE = {"X_ERROR", "Y_ERROR", "Z_ERROR", "DEPOLARIZE1", "PAULI_CHANNEL_1"}
TWO_QUBIT_NOISE = {"DEPOLARIZE2"}
IGNORED = {"TICK", "QUBIT_COORDS", "SHIFT_COORDS"}


@dataclass
class Op:
    """One instruction on its targets: ``qubits`` for gates, resets and
    noise (pairs flattened for two-qubit ones), ``products`` for ``MPP`` (a
    list of (qubit, Pauli letter) lists), ``records`` for detectors and
    observables (negative offsets into the measurement record)."""

    name: str
    args: tuple[float, ...] = ()
    qubits: list[int] = field(default_factory=list)
    products: list[list[tuple[int, str]]] = field(default_factory=list)
    records: list[int] = field(default_factory=list)


_LINE = re.compile(r"^([A-Z_0-9]+)(?:\(([^)]*)\))?\s*(.*)$")


def parse(text: str) -> list[Op]:
    """The instructions of ``text`` in order."""
    ops = []
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        m = _LINE.match(line)
        if m is None:
            raise ValueError(f"cannot parse {raw!r}")
        name, argtext, rest = m.group(1), m.group(2), m.group(3).split()
        args = tuple(float(a) for a in argtext.split(",")) if argtext else ()
        if name in IGNORED:
            continue
        if name in ("DETECTOR", "OBSERVABLE_INCLUDE"):
            recs = []
            for t in rest:
                rm = re.fullmatch(r"rec\[(-\d+)\]", t)
                if rm is None:
                    raise ValueError(f"{name} target {t!r} is not a record")
                recs.append(int(rm.group(1)))
            ops.append(Op(name, args, records=recs))
        elif name == "MPP":
            products = []
            for t in rest:
                factors = []
                for f in t.split("*"):
                    fm = re.fullmatch(r"([XYZ])(\d+)", f)
                    if fm is None:
                        raise ValueError(f"MPP factor {f!r} not understood")
                    factors.append((int(fm.group(2)), fm.group(1)))
                products.append(factors)
            ops.append(Op(name, args, products=products))
        elif name in ONE_QUBIT_GATES | TWO_QUBIT_GATES | set(RESETS) | set(MEASUREMENTS) \
                | ONE_QUBIT_NOISE | TWO_QUBIT_NOISE:
            qubits = [int(t) for t in rest]
            if name in TWO_QUBIT_GATES | TWO_QUBIT_NOISE and len(qubits) % 2:
                raise ValueError(f"{name} needs pairs of qubits: {raw!r}")
            ops.append(Op(name, args, qubits=qubits))
        else:
            raise ValueError(f"instruction {name} is not supported by the reference")
    return ops


@dataclass
class Layout:
    """The measurement record's meaning: for each measurement, in order,
    the output bits it flips (detectors first, then observables, the
    sampler's ``append_observables`` layout)."""

    num_detectors: int
    num_observables: int
    outputs_of_measurement: list[list[int]]

    @property
    def num_outputs(self) -> int:
        return self.num_detectors + self.num_observables


def layout(ops: list[Op]) -> Layout:
    measured = 0
    detectors: list[list[int]] = []
    observables: dict[int, list[int]] = {}
    for op in ops:
        if op.name in MEASUREMENTS:
            measured += len(op.qubits)
        elif op.name == "MPP":
            measured += len(op.products)
        elif op.name in ("DETECTOR", "OBSERVABLE_INCLUDE"):
            absolute = [measured + r for r in op.records]
            if any(a < 0 for a in absolute):
                raise ValueError(f"{op.name} looks back past the first measurement")
            if op.name == "DETECTOR":
                detectors.append(absolute)
            else:
                observables.setdefault(int(op.args[0]) if op.args else 0, []).extend(absolute)
    num_obs = max(observables) + 1 if observables else 0
    outs: list[list[int]] = [[] for _ in range(measured)]
    for d, recs in enumerate(detectors):
        for r in recs:
            outs[r].append(d)
    for k, recs in observables.items():
        for r in recs:
            outs[r].append(len(detectors) + k)
    # A record listed twice in one output cancels.
    outs = [sorted(o for o in set(v) if v.count(o) % 2) for v in outs]
    return Layout(len(detectors), num_obs, outs)
