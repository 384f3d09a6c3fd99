"""Parametric ZX graph.

A from-scratch ZX-diagram data structure supporting boolean phase parameters
on vertices, Hadamard edge types, and a symbolic global :class:`Scalar`.
Functionally equivalent to the reference's external ``pyzx-param`` graph
(reference ``SURVEY.md`` section 2.1 row 2) but an independent design: flat
dict adjacency, Fraction phases in units of pi, frozenset parameter sets.

Vertex types: BOUNDARY=0, Z=1, X=2. Edge types: SIMPLE=1, HADAMARD=2.
A vertex's effective phase is ``phase + pi * XOR(params)``.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Iterable, Iterator

from .scalar import Scalar

BOUNDARY = 0
Z = 1
X = 2

SIMPLE = 1
HADAMARD = 2


class VertexType:
    BOUNDARY = BOUNDARY
    Z = Z
    X = X


class EdgeType:
    SIMPLE = SIMPLE
    HADAMARD = HADAMARD


_ZERO = Fraction(0)


class ZXGraph:
    """Undirected multigraph-free ZX diagram (single edge per vertex pair)."""

    def __init__(self) -> None:
        self._ty: dict[int, int] = {}
        self._phase: dict[int, Fraction] = {}
        self._params: dict[int, frozenset] = {}
        self._qubit: dict[int, float] = {}
        self._row: dict[int, float] = {}
        self._adj: dict[int, dict[int, int]] = {}
        self._vdata: dict[int, dict] = {}
        self._next: int = 0
        self.scalar: Scalar = Scalar()
        self._inputs: tuple[int, ...] = ()
        self._outputs: tuple[int, ...] = ()
        self._bset: frozenset = frozenset()  # inputs | outputs (fast checks)

    # ------------------------------------------------------------- vertices
    def add_vertex(
        self,
        ty: int = Z,
        qubit: float = -1,
        row: float = -1,
        phase=None,
        phaseVars: Iterable | None = None,
    ) -> int:
        v = self._next
        self._next += 1
        self._ty[v] = ty
        if isinstance(phase, str):
            self._phase[v] = _ZERO
            self._params[v] = frozenset({phase})
        else:
            self._phase[v] = Fraction(phase) % 2 if phase else _ZERO
            self._params[v] = frozenset(phaseVars) if phaseVars else frozenset()
        if phaseVars and isinstance(phase, str):
            self._params[v] = frozenset(phaseVars) | {phase}
        self._qubit[v] = qubit
        self._row[v] = row
        self._adj[v] = {}
        return v

    def remove_vertex(self, v: int) -> None:
        for n in list(self._adj[v]):
            del self._adj[n][v]
        del self._adj[v]
        del self._ty[v]
        del self._phase[v]
        del self._params[v]
        del self._qubit[v]
        del self._row[v]
        self._vdata.pop(v, None)
        if v in self._bset:
            self._inputs = tuple(i for i in self._inputs if i != v)
            self._outputs = tuple(o for o in self._outputs if o != v)
            self._bset = frozenset(self._inputs) | frozenset(self._outputs)

    def vertices(self) -> Iterator[int]:
        return iter(list(self._ty.keys()))

    def num_vertices(self) -> int:
        return len(self._ty)

    def type(self, v: int) -> int:
        return self._ty[v]

    def set_type(self, v: int, ty: int) -> None:
        self._ty[v] = ty

    def types(self) -> dict:
        return self._ty

    def phase(self, v: int) -> Fraction:
        return self._phase[v]

    def phases(self) -> dict:
        return self._phase

    def set_phase(self, v: int, phase, clearParams: bool = False) -> None:
        """Set constant phase; a string sets a single phase variable instead."""
        if isinstance(phase, str):
            self._phase[v] = _ZERO
            self._params[v] = frozenset({phase})
        else:
            self._phase[v] = Fraction(phase) % 2
            if clearParams:
                self._params[v] = frozenset()

    def add_to_phase(self, v: int, phase) -> None:
        self._phase[v] = (self._phase[v] + Fraction(phase)) % 2

    def get_params(self, v: int) -> frozenset:
        return self._params[v]

    def set_params(self, v: int, params: Iterable) -> None:
        self._params[v] = frozenset(params)

    def xor_params(self, v: int, params: Iterable) -> None:
        self._params[v] = self._params[v] ^ frozenset(params)

    @property
    def _phaseVars(self):  # reference-API compatible view
        return self._params

    def qubit(self, v: int) -> float:
        return self._qubit[v]

    def set_qubit(self, v: int, q: float) -> None:
        self._qubit[v] = q

    def qubits(self) -> dict:
        return self._qubit

    def row(self, v: int) -> float:
        return self._row[v]

    def set_row(self, v: int, r: float) -> None:
        self._row[v] = r

    def rows(self) -> dict:
        return self._row

    def vdata_keys(self, v: int):
        return list(self._vdata.get(v, {}).keys())

    def vdata(self, v: int, key, default=None):
        return self._vdata.get(v, {}).get(key, default)

    def set_vdata(self, v: int, key, val) -> None:
        self._vdata.setdefault(v, {})[key] = val

    # ---------------------------------------------------------------- edges
    def add_edge(self, edge: tuple[int, int], ty: int = SIMPLE) -> None:
        """Add an edge, overwriting any existing edge between the endpoints."""
        u, v = edge
        if u == v:
            raise ValueError("self-loops must be handled by rewrite rules")
        self._adj[u][v] = ty
        self._adj[v][u] = ty

    def remove_edge(self, edge: tuple[int, int]) -> None:
        u, v = edge
        del self._adj[u][v]
        del self._adj[v][u]

    def connected(self, u: int, v: int) -> bool:
        return v in self._adj[u]

    def edge(self, u: int, v: int) -> tuple[int, int]:
        return (u, v)

    def edge_type(self, edge: tuple[int, int]) -> int:
        u, v = edge
        return self._adj[u][v]

    def set_edge_type(self, edge: tuple[int, int], ty: int) -> None:
        u, v = edge
        self._adj[u][v] = ty
        self._adj[v][u] = ty

    def edges(self) -> list[tuple[int, int]]:
        out = []
        for u, nbrs in self._adj.items():
            for v in nbrs:
                if u < v:
                    out.append((u, v))
        return out

    def num_edges(self) -> int:
        return sum(len(n) for n in self._adj.values()) // 2

    def neighbors(self, v: int) -> list[int]:
        return list(self._adj[v])

    def degree(self, v: int) -> int:
        return len(self._adj[v])

    def incident_edges(self, v: int) -> list[tuple[int, int]]:
        return [(v, n) for n in self._adj[v]]

    # ------------------------------------------------------------ boundaries
    def inputs(self) -> tuple[int, ...]:
        return self._inputs

    def outputs(self) -> tuple[int, ...]:
        return self._outputs

    def set_inputs(self, inputs: Iterable[int]) -> None:
        self._inputs = tuple(inputs)
        self._bset = frozenset(self._inputs) | frozenset(self._outputs)

    def set_outputs(self, outputs: Iterable[int]) -> None:
        self._outputs = tuple(outputs)
        self._bset = frozenset(self._inputs) | frozenset(self._outputs)

    def is_boundary_registered(self, v: int) -> bool:
        return v in self._bset

    # ------------------------------------------------------------- structure
    def copy(self) -> "ZXGraph":
        g = ZXGraph()
        g._ty = dict(self._ty)
        g._phase = dict(self._phase)
        g._params = dict(self._params)
        g._qubit = dict(self._qubit)
        g._row = dict(self._row)
        g._adj = {v: dict(n) for v, n in self._adj.items()}
        g._vdata = {v: dict(d) for v, d in self._vdata.items()}
        g._next = self._next
        g.scalar = self.scalar.copy()
        g._inputs = self._inputs
        g._outputs = self._outputs
        g._bset = self._bset
        return g

    def adjoint(self) -> "ZXGraph":
        """Dagger of the diagram: conjugate phases, swap inputs/outputs."""
        g = self.copy()
        for v in g.vertices():
            g._phase[v] = (-g._phase[v]) % 2
        g.scalar = self.scalar.conjugate()
        g._inputs, g._outputs = self._outputs, self._inputs
        g._bset = frozenset(g._inputs) | frozenset(g._outputs)
        return g

    def compose(self, other: "ZXGraph") -> None:
        """Glue ``other`` after ``self``: self.outputs joined to other.inputs.

        Mutates ``self`` in place. The joined boundary vertices are removed
        and replaced by a direct edge (composing the two boundary edge types).
        """
        if len(self._outputs) != len(other._inputs):
            raise ValueError("composition boundary mismatch")
        vmap: dict[int, int] = {}
        for v in other.vertices():
            vmap[v] = self.add_vertex(
                other._ty[v],
                qubit=other._qubit[v],
                row=other._row[v],
            )
            self._phase[vmap[v]] = other._phase[v]
            self._params[vmap[v]] = other._params[v]
            for key, val in other._vdata.get(v, {}).items():
                self.set_vdata(vmap[v], key, val)
        for u, v in other.edges():
            self.add_edge((vmap[u], vmap[v]), other.edge_type((u, v)))
        self.scalar.mul(other.scalar)

        new_outputs = tuple(vmap[o] for o in other._outputs)
        for out_v, in_v in zip(self._outputs, tuple(vmap[i] for i in other._inputs)):
            # Both are boundary vertices with exactly one neighbor each.
            (n1,) = self.neighbors(out_v)
            (n2,) = self.neighbors(in_v)
            t1 = self._adj[out_v][n1]
            t2 = self._adj[in_v][n2]
            ty = SIMPLE if t1 == t2 else HADAMARD
            self.remove_vertex(out_v)
            self.remove_vertex(in_v)
            if n1 == n2:
                # Wire loops back onto the same vertex: a self-loop.
                from .rules import add_self_loop

                add_self_loop(self, n1, ty)
            else:
                from .rules import add_edge_resolve

                add_edge_resolve(self, n1, n2, ty)
        self._outputs = new_outputs

    def apply_effect(self, effect: str) -> None:
        """Plug each output with an effect character.

        ``'0'``/``'1'``: X spider phase 0/pi with power -1 (exact <0|, <1|).
        ``'+'``/``'-'``: Z spider phase 0/pi with power -1 (exact <+|, <-|).
        Plugged vertices replace the output boundary vertices.
        """
        outputs = self._outputs
        if len(effect) != len(outputs):
            raise ValueError("effect length must match number of outputs")
        table = {"0": (X, 0), "1": (X, 1), "+": (Z, 0), "-": (Z, 1)}
        for ch, v in zip(effect, outputs):
            ty, ph = table[ch]
            self._ty[v] = ty
            self._phase[v] = Fraction(ph)
            self.scalar.add_power(-1)
        self.set_outputs(())

    def normalize(self) -> None:
        """Canonicalize phases into [0, 2)."""
        for v in self.vertices():
            self._phase[v] = self._phase[v] % 2

    # ------------------------------------------------------------- analysis
    def effective_phase(self, v: int, vals: dict) -> Fraction:
        p = self._phase[v]
        x = 0
        for var in self._params[v]:
            x ^= int(vals.get(var, 0)) & 1
        return (p + x) % 2

    def all_params(self) -> set:
        out: set = set()
        for ps in self._params.values():
            out |= set(ps)
        return out | self.scalar.variables()

    def to_tensor(self, preserve_scalar: bool = True):
        from .tensor import graph_to_tensor

        return graph_to_tensor(self, preserve_scalar=preserve_scalar)

    def to_matrix(self, preserve_scalar: bool = True):
        t = self.to_tensor(preserve_scalar=preserve_scalar)
        n_in = len(self._inputs)
        n_out = len(self._outputs)
        return t.reshape(2**n_out, 2**n_in)

    def __repr__(self) -> str:
        return (
            f"ZXGraph({self.num_vertices()} vertices, {self.num_edges()} edges, "
            f"{len(self._inputs)} inputs, {len(self._outputs)} outputs)"
        )
