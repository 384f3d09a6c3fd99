"""Circuit-to-ZX gate builders.

Builds a parametric ZX diagram from a stream of Stim-dialect instructions.
Functional equivalent of reference ``tsim/core/instructions.py`` (gate
recipes re-derived from the gate unitaries; global-phase bookkeeping
verified against exact gate matrices in ``tests/unit/core``).

Layout model: each qubit has a *lane* ending in a boundary "dummy" vertex
(``last_vertex``); applying a gate converts the dummy into a spider and
appends a fresh dummy. Measurements attach ``rec[k]``/``m[k]`` phase
variables; noise channels attach ``e{i}`` variables; detectors/observables
are X spiders wired to the recorded measurement vertices.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from fractions import Fraction
from typing import Callable, Literal

import numpy as np

from ..zx.graph import BOUNDARY, HADAMARD, SIMPLE, X, Z, ZXGraph
from ..noise.channels import (
    correlated_error_probs,
    error_probs,
    heralded_pauli_channel_1_probs,
    pauli_channel_1_probs,
    pauli_channel_2_probs,
)

F = Fraction


@dataclass
class GraphRepresentation:
    """ZX graph built from a circuit plus sampling bookkeeping."""

    graph: ZXGraph = field(default_factory=ZXGraph)
    rec: list[int] = field(default_factory=list)
    silent_rec: list[int] = field(default_factory=list)
    detectors: list[int] = field(default_factory=list)
    observables_dict: dict[int, int] = field(default_factory=dict)
    first_vertex: dict[int, int] = field(default_factory=dict)
    last_vertex: dict[int, int] = field(default_factory=dict)
    channel_probs: list[np.ndarray] = field(default_factory=list)
    correlated_error_probs: list[float] = field(default_factory=list)
    num_error_bits: int = 0
    num_correlated_error_bits: int = 0

    @property
    def observables(self) -> list[int]:
        return [self.observables_dict[i] for i in sorted(self.observables_dict)]


# ------------------------------------------------------------------ plumbing

def last_row(b: GraphRepresentation, qubit: int) -> float:
    return b.graph.row(b.last_vertex[qubit])


def add_dummy(b: GraphRepresentation, qubit: int, row=None) -> int:
    if row is None:
        row = last_row(b, qubit) + 1
    v = b.graph.add_vertex(BOUNDARY, qubit=qubit, row=row)
    b.last_vertex[qubit] = v
    return v


def add_lane(b: GraphRepresentation, qubit: int) -> int:
    v1 = b.graph.add_vertex(BOUNDARY, qubit=qubit, row=0)
    v2 = b.graph.add_vertex(BOUNDARY, qubit=qubit, row=1)
    b.graph.add_edge((v1, v2), SIMPLE)
    b.first_vertex[qubit] = v1
    b.last_vertex[qubit] = v2
    return v1


def ensure_lane(b: GraphRepresentation, qubit: int) -> None:
    if qubit not in b.last_vertex:
        add_lane(b, qubit)


def _last_edge(b: GraphRepresentation, qubit: int):
    v = b.last_vertex[qubit]
    edges = b.graph.incident_edges(v)
    assert len(edges) == 1
    return edges[0]


# ------------------------------------------------------------ phase spiders

def x_phase(b: GraphRepresentation, qubit: int, phase) -> None:
    ensure_lane(b, qubit)
    v1 = b.last_vertex[qubit]
    b.graph.set_type(v1, X)
    b.graph.set_phase(v1, F(phase) % 2)
    v2 = add_dummy(b, qubit)
    b.graph.add_edge((v1, v2), SIMPLE)


def z_phase(b: GraphRepresentation, qubit: int, phase) -> None:
    ensure_lane(b, qubit)
    v1 = b.last_vertex[qubit]
    b.graph.set_type(v1, Z)
    b.graph.set_phase(v1, F(phase) % 2)
    v2 = add_dummy(b, qubit)
    b.graph.add_edge((v1, v2), SIMPLE)


# --------------------------------------------------------------- rotations

def t(b, qubit):
    z_phase(b, qubit, F(1, 4))


def t_dag(b, qubit):
    z_phase(b, qubit, F(-1, 4))


def r_z(b, qubit, phase) -> None:
    """R_Z(a*pi) = e^{-i a pi/2} diag(1, e^{i a pi})."""
    z_phase(b, qubit, phase)
    b.graph.scalar.add_phase(-F(phase) / 2)


def r_x(b, qubit, phase) -> None:
    x_phase(b, qubit, phase)
    b.graph.scalar.add_phase(-F(phase) / 2)


def r_y(b, qubit, phase) -> None:
    h_yz(b, qubit)
    r_z(b, qubit, phase)
    h_yz(b, qubit)


def u3(b, qubit, theta, phi, lambda_) -> None:
    """U3(t, p, l) = e^{i (p + l) / 2 * pi} R_Z(p) R_Y(t) R_Z(l)."""
    r_z(b, qubit, lambda_)
    r_y(b, qubit, theta)
    r_z(b, qubit, phi)
    b.graph.scalar.add_phase((F(phi) + F(lambda_)) / 2)


# ------------------------------------------------------------------- paulis

def i(b, qubit, *_args) -> None:
    ensure_lane(b, qubit)
    v = b.last_vertex[qubit]
    b.graph.set_row(v, last_row(b, qubit) + 1)


def ii(b, q1, q2, *_args) -> None:
    i(b, q1)
    i(b, q2)


def x(b, qubit):
    x_phase(b, qubit, 1)


def z(b, qubit):
    z_phase(b, qubit, 1)


def y(b, qubit):
    """Y = i X Z (Z first in circuit order)."""
    z(b, qubit)
    x(b, qubit)
    b.graph.scalar.add_phase(F(1, 2))


# ------------------------------------------------- single-qubit cliffords

def h(b, qubit) -> None:
    ensure_lane(b, qubit)
    e = _last_edge(b, qubit)
    g = b.graph
    g.set_edge_type(e, HADAMARD if g.edge_type(e) == SIMPLE else SIMPLE)


def s(b, qubit):
    z_phase(b, qubit, F(1, 2))


def s_dag(b, qubit):
    z_phase(b, qubit, F(-1, 2))


def sqrt_x(b, qubit):
    x_phase(b, qubit, F(1, 2))


def sqrt_x_dag(b, qubit):
    x_phase(b, qubit, F(-1, 2))


def sqrt_y(b, qubit):
    """SQRT_Y = e^{i pi/4} H Z  (Z first in circuit order)."""
    z(b, qubit)
    h(b, qubit)
    b.graph.scalar.add_phase(F(1, 4))


def sqrt_y_dag(b, qubit):
    """SQRT_Y_DAG = e^{-i pi/4} Z H (H first in circuit order)."""
    h(b, qubit)
    z(b, qubit)
    b.graph.scalar.add_phase(F(-1, 4))


def h_xy(b, qubit):
    """H_XY: X<->Y, Z->-Z. Equals e^{-i pi/4} S X."""
    x(b, qubit)
    s(b, qubit)
    b.graph.scalar.add_phase(F(-1, 4))


def h_nxy(b, qubit):
    x(b, qubit)
    s_dag(b, qubit)
    b.graph.scalar.add_phase(F(1, 4))


def h_yz(b, qubit):
    """H_YZ: Y<->Z, X->-X. Equals e^{-i pi/4} Z SQRT_X."""
    sqrt_x(b, qubit)
    z(b, qubit)
    b.graph.scalar.add_phase(F(-1, 4))


def h_nyz(b, qubit):
    z(b, qubit)
    sqrt_x(b, qubit)
    b.graph.scalar.add_phase(F(-1, 4))


def h_nxz(b, qubit):
    z(b, qubit)
    sqrt_y_dag(b, qubit)
    b.graph.scalar.add_phase(F(1, 4))


def c_xyz(b, qubit):
    """C_XYZ: X->Y->Z->X. Equals e^{-i pi/4} H S_DAG."""
    s_dag(b, qubit)
    h(b, qubit)
    b.graph.scalar.add_phase(F(-1, 4))


def c_zyx(b, qubit):
    h(b, qubit)
    s(b, qubit)
    b.graph.scalar.add_phase(F(1, 4))


def c_nxyz(b, qubit):
    sqrt_x(b, qubit)
    s_dag(b, qubit)


def c_xnyz(b, qubit):
    s_dag(b, qubit)
    sqrt_y(b, qubit)


def c_xynz(b, qubit):
    s(b, qubit)
    sqrt_y_dag(b, qubit)


def c_nzyx(b, qubit):
    s_dag(b, qubit)
    sqrt_x(b, qubit)


def c_znyx(b, qubit):
    sqrt_x(b, qubit)
    sqrt_y_dag(b, qubit)


def c_zynx(b, qubit):
    s(b, qubit)
    sqrt_x_dag(b, qubit)


# --------------------------------------------------------- two-qubit gates

def _cx_cz(
    b: GraphRepresentation,
    is_cx: bool,
    control: int,
    target: int,
    classically_controlled: list[bool] | None = None,
) -> None:
    """CX/CZ core: Z spider on control, X (CX) or Z-with-H-edge (CZ) on
    target, bridge edge, sqrt(2) scalar.

    A measurement-record control wires the recorded measurement spider
    directly to the target spider instead of a live qubit lane.
    """
    g = b.graph
    edge_type = SIMPLE if is_cx else HADAMARD
    vertex_type = X if is_cx else Z

    m_vertex = None
    if classically_controlled:
        assert len(classically_controlled) == 2
        if classically_controlled[1] and not is_cx:
            classically_controlled = classically_controlled[::-1]
            control, target = target, control
        if classically_controlled[1]:
            raise ValueError("Measurement record editing is not supported.")
        m_vertex = b.rec[control]

    ensure_lane(b, target)
    if m_vertex is None:
        ensure_lane(b, control)
        row = max(last_row(b, control), last_row(b, target))
        v1 = b.last_vertex[control]
        g.set_type(v1, Z)
        g.set_row(v1, row)
        v3 = add_dummy(b, control, int(row + 1))
        g.add_edge((v1, v3), SIMPLE)
    else:
        row = last_row(b, target)
        v1 = m_vertex

    if m_vertex is None and control == target:
        row += 1

    v2 = b.last_vertex[target]
    g.set_type(v2, vertex_type)
    g.set_row(v2, row)
    v4 = add_dummy(b, target, int(row + 1))
    g.add_edge((v2, v4), SIMPLE)

    g.add_edge((v1, v2), edge_type)
    g.scalar.add_power(1)


def cnot(b, control, target, classically_controlled=None):
    _cx_cz(b, True, control, target, classically_controlled)


def cz(b, control, target, classically_controlled=None):
    _cx_cz(b, False, control, target, classically_controlled)


def cy(b, control, target, classically_controlled=None):
    s_dag(b, target)
    cnot(b, control, target, classically_controlled)
    s(b, target)


def swap(b, q1, q2) -> None:
    ensure_lane(b, q1)
    ensure_lane(b, q2)
    v1, v2 = b.last_vertex[q1], b.last_vertex[q2]
    b.last_vertex[q1], b.last_vertex[q2] = v2, v1
    b.graph.set_qubit(v1, q2)
    b.graph.set_qubit(v2, q1)


def cxswap(b, q1, q2):
    cnot(b, q1, q2)
    swap(b, q1, q2)


def czswap(b, q1, q2):
    cz(b, q1, q2)
    swap(b, q1, q2)


def swapcx(b, q1, q2):
    swap(b, q1, q2)
    cnot(b, q1, q2)


def swapcz(b, q1, q2):
    swap(b, q1, q2)
    cz(b, q1, q2)


def iswap(b, q1, q2):
    cnot(b, q1, q2)
    s(b, q2)
    cnot(b, q1, q2)
    swap(b, q1, q2)


def iswap_dag(b, q1, q2):
    cnot(b, q1, q2)
    s_dag(b, q2)
    cnot(b, q1, q2)
    swap(b, q1, q2)


def sqrt_xx(b, q1, q2):
    cnot(b, q1, q2)
    sqrt_x(b, q1)
    cnot(b, q1, q2)


def sqrt_xx_dag(b, q1, q2):
    cnot(b, q1, q2)
    sqrt_x_dag(b, q1)
    cnot(b, q1, q2)


def sqrt_zz(b, q1, q2):
    cnot(b, q1, q2)
    s(b, q2)
    cnot(b, q1, q2)


def sqrt_zz_dag(b, q1, q2):
    cnot(b, q1, q2)
    s_dag(b, q2)
    cnot(b, q1, q2)


def sqrt_yy(b, q1, q2):
    """SQRT_YY via basis rotation: (H_YZ x H_YZ) SQRT_ZZ (H_YZ x H_YZ)...
    implemented as conjugated SQRT_XX with S gates; verified by matrix."""
    s_dag(b, q1)
    s_dag(b, q2)
    sqrt_xx(b, q1, q2)
    s(b, q1)
    s(b, q2)


def sqrt_yy_dag(b, q1, q2):
    s_dag(b, q1)
    s_dag(b, q2)
    sqrt_xx_dag(b, q1, q2)
    s(b, q1)
    s(b, q2)


def xcx(b, control, target):
    h(b, control)
    cnot(b, control, target)
    h(b, control)


def xcy(b, control, target):
    h(b, control)
    cy(b, control, target)
    h(b, control)


def xcz(b, control, target, classically_controlled=None):
    cnot(
        b,
        target,
        control,
        classically_controlled[::-1] if classically_controlled else None,
    )


def ycx(b, control, target):
    h_yz(b, control)
    cnot(b, control, target)
    h_yz(b, control)


def ycy(b, control, target):
    h_yz(b, control)
    cy(b, control, target)
    h_yz(b, control)


def ycz(b, control, target, classically_controlled=None):
    cy(
        b,
        target,
        control,
        classically_controlled[::-1] if classically_controlled else None,
    )


# ----------------------------------------------------------- noise channels

def _error(b: GraphRepresentation, qubit: int, error_type: int, var: str) -> None:
    """Insert a parametrized error spider (phase pi * var) on a lane."""
    ensure_lane(b, qubit)
    v1 = b.last_vertex[qubit]
    v2 = add_dummy(b, qubit)
    b.graph.add_edge((v1, v2), SIMPLE)
    b.graph.set_type(v1, error_type)
    b.graph.set_phase(v1, var)  # string -> single phase variable


def pauli_channel_1(b, qubit, px, py, pz) -> None:
    b.channel_probs.append(pauli_channel_1_probs(px, py, pz))
    _error(b, qubit, Z, f"e{b.num_error_bits}")
    _error(b, qubit, X, f"e{b.num_error_bits + 1}")
    b.num_error_bits += 2


def pauli_channel_2(b, qi, qj, *probs) -> None:
    assert len(probs) == 15
    b.channel_probs.append(pauli_channel_2_probs(*probs))
    _error(b, qi, Z, f"e{b.num_error_bits}")
    _error(b, qi, X, f"e{b.num_error_bits + 1}")
    _error(b, qj, Z, f"e{b.num_error_bits + 2}")
    _error(b, qj, X, f"e{b.num_error_bits + 3}")
    b.num_error_bits += 4


def depolarize1(b, qubit, p):
    pauli_channel_1(b, qubit, p / 3, p / 3, p / 3)


def depolarize2(b, qi, qj, p):
    pauli_channel_2(b, qi, qj, *([p / 15] * 15))


def x_error(b, qubit, p):
    b.channel_probs.append(error_probs(p))
    _error(b, qubit, X, f"e{b.num_error_bits}")
    b.num_error_bits += 1


def z_error(b, qubit, p):
    b.channel_probs.append(error_probs(p))
    _error(b, qubit, Z, f"e{b.num_error_bits}")
    b.num_error_bits += 1


def y_error(b, qubit, p):
    b.channel_probs.append(error_probs(p))
    var = f"e{b.num_error_bits}"
    _error(b, qubit, Z, var)
    _error(b, qubit, X, var)
    b.num_error_bits += 1


def heralded_pauli_channel_1(b, qubit, pi_, px, py, pz) -> None:
    b.channel_probs.append(heralded_pauli_channel_1_probs(pi_, px, py, pz))
    aux = -2
    r(b, aux)
    _error(b, aux, X, f"e{b.num_error_bits}")
    m(b, aux)
    _error(b, qubit, Z, f"e{b.num_error_bits + 1}")
    _error(b, qubit, X, f"e{b.num_error_bits + 2}")
    b.num_error_bits += 3


def heralded_erase(b, qubit, p):
    heralded_pauli_channel_1(b, qubit, p / 4, p / 4, p / 4, p / 4)


def correlated_error(b, qubits, types, p) -> None:
    for qubit, ty in zip(qubits, types):
        if ty in ("X", "Y"):
            _error(b, qubit, X, f"c{b.num_correlated_error_bits}")
        if ty in ("Z", "Y"):
            _error(b, qubit, Z, f"c{b.num_correlated_error_bits}")
    b.correlated_error_probs.append(p)
    b.num_correlated_error_bits += 1


def finalize_correlated_error(b: GraphRepresentation) -> None:
    k = b.num_correlated_error_bits
    if k == 0:
        return
    for v in b.graph.vertices():
        ps = b.graph.get_params(v)
        if any(isinstance(p, str) and p.startswith("c") for p in ps):
            newps = set()
            for p in ps:
                if isinstance(p, str) and p.startswith("c"):
                    newps.add(f"e{b.num_error_bits + int(p[1:])}")
                else:
                    newps.add(p)
            b.graph.set_params(v, newps)
    b.channel_probs.append(correlated_error_probs(b.correlated_error_probs))
    b.num_error_bits += k
    b.num_correlated_error_bits = 0
    b.correlated_error_probs = []


# --------------------------------------------------------- collapsing gates

def _m(b: GraphRepresentation, qubit: int, p: float = 0, silent: bool = False) -> None:
    error_var = ""
    if p > 0:
        b.channel_probs.append(error_probs(p))
        error_var = f"e{b.num_error_bits}"
        _error(b, qubit, X, error_var)
        b.num_error_bits += 1
    ensure_lane(b, qubit)
    v1 = b.last_vertex[qubit]
    b.graph.set_type(v1, Z)
    if not silent:
        b.graph.set_phase(v1, f"rec[{len(b.rec)}]")
        b.rec.append(v1)
    else:
        b.graph.set_phase(v1, f"m[{len(b.silent_rec)}]")
        b.silent_rec.append(v1)
    v2 = add_dummy(b, qubit)
    b.graph.add_edge((v1, v2), SIMPLE)
    if p > 0:
        _error(b, qubit, X, error_var)
    b.graph.scalar.add_power(-1)


def _r(b: GraphRepresentation, qubit: int) -> None:
    g = b.graph
    if qubit not in b.last_vertex:
        v1 = add_lane(b, qubit)
        g.set_type(v1, X)
        g.scalar.add_power(-1)
    else:
        _m(b, qubit, silent=True)
        row = last_row(b, qubit)
        v1 = b.last_vertex[qubit]
        g.set_type(v1, X)
        (v2,) = g.neighbors(v1)
        g.remove_edge((v1, v2))
        v3 = add_dummy(b, qubit, row + 1)
        g.add_edge((v1, v3), SIMPLE)
        g.scalar.add_power(-1)


def m(b, qubit, p: float = 0, invert: bool = False) -> None:
    if invert:
        x(b, qubit)
    _m(b, qubit, p, silent=False)
    if invert:
        x(b, qubit)


def mx(b, qubit, p=0, invert=False):
    h(b, qubit)
    m(b, qubit, p=p, invert=invert)
    h(b, qubit)


def my(b, qubit, p=0, invert=False):
    h_yz(b, qubit)
    m(b, qubit, p=p, invert=invert)
    h_yz(b, qubit)


def mr(b, qubit, p=0, invert=False):
    m(b, qubit, p=p, invert=invert)
    _r(b, qubit)


def mrx(b, qubit, p=0, invert=False):
    h(b, qubit)
    m(b, qubit, p=p, invert=invert)
    _r(b, qubit)
    h(b, qubit)


def mry(b, qubit, p=0, invert=False):
    h_yz(b, qubit)
    m(b, qubit, p=p, invert=invert)
    _r(b, qubit)
    h_yz(b, qubit)


def r(b, qubit):
    _r(b, qubit)


def rx(b, qubit):
    if qubit in b.last_vertex:
        h(b, qubit)
    r(b, qubit)
    h(b, qubit)


def ry(b, qubit):
    if qubit in b.last_vertex:
        h_yz(b, qubit)
    r(b, qubit)
    h_yz(b, qubit)


def mpp(b, paulis, invert: bool = False, p: float = 0) -> None:
    """Measure a Pauli product via an ancilla in the |+> basis."""
    aux = -2
    r(b, aux)
    h(b, aux)
    for ty, qubit in paulis:
        if ty == "X":
            cnot(b, aux, qubit)
        elif ty == "Z":
            cz(b, aux, qubit)
        elif ty == "Y":
            cy(b, aux, qubit)
        else:
            raise ValueError(f"Invalid Pauli operator: {ty}")
    h(b, aux)
    m(b, aux, p=p, invert=invert)


def mxx(b, q0, q1, p=0, invert=False):
    mpp(b, [("X", q0), ("X", q1)], invert, p=p)


def myy(b, q0, q1, p=0, invert=False):
    mpp(b, [("Y", q0), ("Y", q1)], invert, p=p)


def mzz(b, q0, q1, p=0, invert=False):
    mpp(b, [("Z", q0), ("Z", q1)], invert, p=p)


def mpad(b, value: int, p: float = 0) -> None:
    aux = -2
    r(b, aux)
    if value == 1:
        x(b, aux)
    m(b, aux, p=p)


# -------------------------------------------------- pauli product rotations

def _pauli_product_phase(b, paulis, phase_gate, phase_gate_dag, dagger) -> None:
    """exp(-i theta P) via basis rotation + CNOT parity fold + phase."""
    if len(paulis) == 0:
        return
    for ty, qubit in paulis:
        if ty == "X":
            h(b, qubit)
        elif ty == "Y":
            s_dag(b, qubit)
            h(b, qubit)
    _, last_qubit = paulis[-1]
    for _, qubit in paulis[:-1]:
        cnot(b, qubit, last_qubit)
    if dagger:
        phase_gate_dag(b, last_qubit)
    else:
        phase_gate(b, last_qubit)
    for _, qubit in reversed(paulis[:-1]):
        cnot(b, qubit, last_qubit)
    for ty, qubit in paulis:
        if ty == "X":
            h(b, qubit)
        elif ty == "Y":
            h(b, qubit)
            s(b, qubit)


def spp(b, paulis, dagger: bool = False) -> None:
    _pauli_product_phase(b, paulis, s, s_dag, dagger)


def tpp(b, paulis, dagger: bool = False) -> None:
    _pauli_product_phase(b, paulis, t, t_dag, dagger)


def r_pauli(b, paulis, theta, dagger: bool = False) -> None:
    _pauli_product_phase(
        b,
        paulis,
        lambda b_, q: r_z(b_, q, theta),
        lambda b_, q: r_z(b_, q, -theta),
        dagger,
    )


# --------------------------------------------------------------- annotations

def _annotation_row(b: GraphRepresentation, rec_idx: list[int]) -> float:
    d_rows = {b.graph.row(d) for d in b.detectors + b.observables}
    if rec_idx:
        row = min(b.graph.row(b.rec[k]) for k in rec_idx) - 0.5
    else:
        row = (max(d_rows) + 1) if d_rows else 0
    while row in d_rows:
        row += 1
    return row


def detector(b: GraphRepresentation, rec_idx: list[int], *args) -> None:
    row = _annotation_row(b, rec_idx)
    v0 = b.graph.add_vertex(X, qubit=-1, row=row, phase=f"det[{len(b.detectors)}]")
    for k in rec_idx:
        b.graph.add_edge((v0, b.rec[k]))
    b.detectors.append(v0)


def observable_include(b: GraphRepresentation, rec_idx: list[int], idx: int) -> None:
    idx = int(idx)
    if idx not in b.observables_dict:
        row = _annotation_row(b, rec_idx)
        v0 = b.graph.add_vertex(X, qubit=-1, row=row, phase=f"obs[{idx}]")
        b.observables_dict[idx] = v0
    v0 = b.observables_dict[idx]
    for k in rec_idx:
        b.graph.add_edge((v0, b.rec[k]))


def tick(b: GraphRepresentation) -> None:
    if not b.last_vertex:
        return
    row = max(last_row(b, q) for q in b.last_vertex)
    for q in b.last_vertex:
        b.graph.set_row(b.last_vertex[q], row)


# --------------------------------------------------------- dispatch table

GATE_TABLE: dict[str, tuple[Callable[..., None], int]] = {
    "I": (i, 1),
    "I_ERROR": (i, 1),
    "QUBIT_COORDS": (i, 1),
    "II": (ii, 2),
    "II_ERROR": (ii, 2),
    "X": (x, 1),
    "Y": (y, 1),
    "Z": (z, 1),
    "T": (t, 1),
    "T_DAG": (t_dag, 1),
    "C_NXYZ": (c_nxyz, 1),
    "C_NZYX": (c_nzyx, 1),
    "C_XNYZ": (c_xnyz, 1),
    "C_XYNZ": (c_xynz, 1),
    "C_XYZ": (c_xyz, 1),
    "C_ZNYX": (c_znyx, 1),
    "C_ZYNX": (c_zynx, 1),
    "C_ZYX": (c_zyx, 1),
    "H": (h, 1),
    "H_NXY": (h_nxy, 1),
    "H_NXZ": (h_nxz, 1),
    "H_NYZ": (h_nyz, 1),
    "H_XY": (h_xy, 1),
    "H_XZ": (h, 1),
    "H_YZ": (h_yz, 1),
    "S": (s, 1),
    "SQRT_X": (sqrt_x, 1),
    "SQRT_X_DAG": (sqrt_x_dag, 1),
    "SQRT_Y": (sqrt_y, 1),
    "SQRT_Y_DAG": (sqrt_y_dag, 1),
    "SQRT_Z": (s, 1),
    "SQRT_Z_DAG": (s_dag, 1),
    "S_DAG": (s_dag, 1),
    "CNOT": (cnot, 2),
    "CX": (cnot, 2),
    "CXSWAP": (cxswap, 2),
    "CZ": (cz, 2),
    "CZSWAP": (czswap, 2),
    "CY": (cy, 2),
    "ISWAP": (iswap, 2),
    "ISWAP_DAG": (iswap_dag, 2),
    "SQRT_XX": (sqrt_xx, 2),
    "SQRT_XX_DAG": (sqrt_xx_dag, 2),
    "SQRT_YY": (sqrt_yy, 2),
    "SQRT_YY_DAG": (sqrt_yy_dag, 2),
    "SQRT_ZZ": (sqrt_zz, 2),
    "SQRT_ZZ_DAG": (sqrt_zz_dag, 2),
    "SWAP": (swap, 2),
    "SWAPCX": (swapcx, 2),
    "SWAPCZ": (swapcz, 2),
    "XCX": (xcx, 2),
    "XCY": (xcy, 2),
    "XCZ": (xcz, 2),
    "YCX": (ycx, 2),
    "YCY": (ycy, 2),
    "YCZ": (ycz, 2),
    "ZCX": (cnot, 2),
    "ZCY": (cy, 2),
    "ZCZ": (cz, 2),
    "DEPOLARIZE1": (depolarize1, 1),
    "DEPOLARIZE2": (depolarize2, 2),
    "PAULI_CHANNEL_1": (pauli_channel_1, 1),
    "PAULI_CHANNEL_2": (pauli_channel_2, 2),
    "HERALDED_ERASE": (heralded_erase, 1),
    "HERALDED_PAULI_CHANNEL_1": (heralded_pauli_channel_1, 1),
    "X_ERROR": (x_error, 1),
    "Y_ERROR": (y_error, 1),
    "Z_ERROR": (z_error, 1),
    "M": (m, 1),
    "MR": (mr, 1),
    "MRX": (mrx, 1),
    "MRY": (mry, 1),
    "MRZ": (mr, 1),
    "MX": (mx, 1),
    "MY": (my, 1),
    "MZ": (m, 1),
    "MXX": (mxx, 2),
    "MYY": (myy, 2),
    "MZZ": (mzz, 2),
    "R": (r, 1),
    "RX": (rx, 1),
    "RY": (ry, 1),
    "RZ": (r, 1),
}
