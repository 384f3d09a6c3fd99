"""ctypes bridge to the native (C++) parametric-ZX reduction engine.

Serializes a :class:`~tsim_tpu_torch.zx.graph.ZXGraph` (structure + symbolic
scalar) into flat int64/double streams, runs ``zx_full_reduce`` from
``native/src/zx_reduce.cpp``, and rebuilds the graph in place. On any
unsupported construct (overflowing fractions, exotic parallel edges) the
native call reports an error and the caller falls back to the Python engine
— the Python graph is only replaced on success, so fallback is always clean.

Set ``TSIM_TPU_NATIVE_ZX=0`` to disable the native path. Each call that
falls back to the Python engine while the library is loaded adds one to
``fallbacks``, so a compile can report that the Python engine planned part
of it (``compile_stats["planner"] == "mixed"``).
"""

from __future__ import annotations

import ctypes
import os
from array import array
from fractions import Fraction

from .graph import ZXGraph
from .scalar import ExactDyadic, PhasePair, Scalar

_LIM = 1 << 62

_lib = None
_lib_failed = False
fallbacks = 0  # native calls that handed their graph back to the Python engine


def _fell_back():
    global fallbacks
    fallbacks += 1


def _load():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    if os.environ.get("TSIM_TPU_NATIVE_ZX", "1") == "0":
        _lib_failed = True
        return None
    try:
        from ..native.build import load_library

        lib = load_library("zx_reduce")
        lib.zx_full_reduce.restype = ctypes.c_int
        lib.zx_full_reduce.argtypes = [
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.zx_free_i64.argtypes = [ctypes.POINTER(ctypes.c_int64)]
        lib.zx_free_f64.argtypes = [ctypes.POINTER(ctypes.c_double)]
        lib.zx_plan_cover.restype = ctypes.c_int
        lib.zx_plan_cover.argtypes = [
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_double,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.zx_planned_enumerate.restype = ctypes.c_int
        lib.zx_planned_enumerate.argtypes = [
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        _lib = lib
    except Exception:
        _lib_failed = True
        return None
    return _lib


def _frac_ok(f: Fraction) -> bool:
    return -_LIM < f.numerator < _LIM and f.denominator < _LIM


class _Encoder:
    def __init__(self):
        self.ints = array("q")
        self.floats = array("d")
        self.names: list[str] = ["1"]
        self.ids: dict[str, int] = {"1": 0}
        self.ok = True
        # Param sets repeat heavily across vertices/scalar terms; var ids
        # are stable within one encoder, so cache the encoded id runs.
        self._pset_cache: dict[frozenset, tuple] = {}

    def var(self, name: str) -> int:
        i = self.ids.get(name)
        if i is None:
            i = len(self.names)
            self.ids[name] = i
            self.names.append(name)
        return i

    def pset(self, params) -> None:
        if isinstance(params, frozenset):
            run = self._pset_cache.get(params)
            if run is None:
                run = (len(params), *sorted(self.var(p) for p in params))
                self._pset_cache[params] = run
            self.ints.extend(run)
            return
        self.ints.append(len(params))
        self.ints.extend(sorted(self.var(p) for p in params))

    def frac(self, f: Fraction) -> None:
        if not _frac_ok(f):
            self.ok = False
            self.ints.append(0)
            self.ints.append(1)
            return
        self.ints.append(f.numerator)
        self.ints.append(f.denominator)


def encode_graph(g: ZXGraph, enc: _Encoder) -> None:
    ints, floats = enc.ints, enc.floats
    verts = list(g._ty.keys())
    ints.append(g._next)
    ints.append(len(verts))
    ints.append(g.num_edges())
    ints.append(len(g._inputs))
    ints.append(len(g._outputs))
    for v in verts:
        ints.append(v)
        ints.append(g._ty[v])
        enc.frac(g._phase[v])
        enc.pset(g._params[v])
        floats.append(g._qubit[v])
        floats.append(g._row[v])
    for u, nbrs in g._adj.items():
        for v, t in nbrs.items():
            if u < v:
                ints.append(u)
                ints.append(v)
                ints.append(t)
    ints.extend(g._inputs)
    ints.extend(g._outputs)
    s = g.scalar
    ints.append(1 if s.is_zero else 0)
    ints.append(s.power2)
    enc.frac(s.phase)
    ff = s.floatfactor
    for x in (ff.a, ff.b, ff.c, ff.d):
        if not -_LIM < x < _LIM:
            enc.ok = False
            x = 0
        ints.append(x)
    z = complex(s.approximate_floatfactor)
    floats.append(z.real)
    floats.append(z.imag)
    enc.pset(s.phasevars_pi)
    half = [(j, vs) for j, lst in s.phasevars_halfpi.items() for vs in lst]
    ints.append(len(half))
    for j, vs in half:
        ints.append(j)
        enc.pset(vs)
    ints.append(len(s.phasevars_pi_pair))
    for psi, phi in s.phasevars_pi_pair:
        enc.pset(psi)
        enc.pset(phi)
    ints.append(len(s.phasenodes))
    for ph, vs in zip(s.phasenodes, s.phasenodevars):
        enc.frac(ph)
        enc.pset(vs)
    ints.append(len(s.phasepairs))
    for pp in s.phasepairs:
        ints.append(pp.alpha)
        ints.append(pp.beta)
        enc.pset(pp.paramsA)
        enc.pset(pp.paramsB)


_EMPTY_PSET: frozenset = frozenset()
_FRAC_CACHE: dict[tuple[int, int], Fraction] = {}


class _Decoder:
    def __init__(self, ints, floats, names):
        self.ints = ints
        self.floats = floats
        self.names = names
        self.i = 0
        self.f = 0
        # Decoded sets/fractions repeat heavily; returning shared interned
        # objects both skips construction and speeds downstream hashing.
        self._pset_cache: dict[tuple, frozenset] = {}

    def next(self) -> int:
        v = self.ints[self.i]
        self.i += 1
        return v

    def nextf(self) -> float:
        v = self.floats[self.f]
        self.f += 1
        return v

    def pset(self) -> frozenset:
        n = self.next()
        if n == 0:
            return _EMPTY_PSET
        i = self.i
        self.i = i + n
        key = tuple(self.ints[i : i + n])
        cached = self._pset_cache.get(key)
        if cached is None:
            names = self.names
            cached = frozenset(names[k] for k in key)
            self._pset_cache[key] = cached
        return cached

    def frac(self) -> Fraction:
        n = self.next()
        d = self.next()
        key = (n, d)
        cached = _FRAC_CACHE.get(key)
        if cached is None:
            if len(_FRAC_CACHE) > 1 << 16:
                _FRAC_CACHE.clear()
            cached = Fraction(n, d)
            _FRAC_CACHE[key] = cached
        return cached


def decode_graph(dec: _Decoder, g: ZXGraph) -> None:
    """Rebuild ``g`` in place from the decoder's streams."""
    nxt = dec.next()
    n_verts = dec.next()
    n_edges = dec.next()
    n_in = dec.next()
    n_out = dec.next()
    ty = {}
    phase = {}
    params = {}
    qubit = {}
    row = {}
    adj: dict[int, dict[int, int]] = {}
    for _ in range(n_verts):
        v = dec.next()
        ty[v] = dec.next()
        phase[v] = dec.frac()
        params[v] = dec.pset()
        qubit[v] = dec.nextf()
        row[v] = dec.nextf()
        adj[v] = {}
    for _ in range(n_edges):
        u = dec.next()
        v = dec.next()
        t = dec.next()
        adj[u][v] = t
        adj[v][u] = t
    inputs = tuple(dec.next() for _ in range(n_in))
    outputs = tuple(dec.next() for _ in range(n_out))

    s = Scalar()
    s.is_zero = dec.next() != 0
    s.power2 = dec.next()
    s.phase = dec.frac()
    s.floatfactor = ExactDyadic(dec.next(), dec.next(), dec.next(), dec.next())
    s.approximate_floatfactor = complex(dec.nextf(), dec.nextf())
    s.phasevars_pi = dec.pset()
    for _ in range(dec.next()):
        j = dec.next()
        s.phasevars_halfpi.setdefault(j, []).append(dec.pset())
    for _ in range(dec.next()):
        psi = dec.pset()
        phi = dec.pset()
        s.phasevars_pi_pair.append((psi, phi))
    for _ in range(dec.next()):
        ph = dec.frac()
        s.add_node(ph, dec.pset())  # canonicalizes projector nodes
    for _ in range(dec.next()):
        a = dec.next()
        b = dec.next()
        pa = dec.pset()
        pb = dec.pset()
        s.phasepairs.append(PhasePair(a, b, pa, pb))

    g._ty = ty
    g._phase = phase
    g._params = params
    g._qubit = qubit
    g._row = row
    g._adj = adj
    g._vdata = {}
    g._next = nxt
    g.scalar = s
    g._inputs = inputs
    g._outputs = outputs
    g._bset = frozenset(inputs) | frozenset(outputs)


def native_plan_cover(
    umask: list[int],
    lhmask: list[int],
    dmask: dict,
    allowed_set,
    drop_w: float,
    budget: int,
) -> list[tuple[int, int]] | None:
    """Run the min-rank matching planner's greedy + iterated local search
    natively (zx_plan_cover). Inputs are the planner's int-bitmask gadget
    vectors; returns the chosen (i, j) index pairs, or None when the
    native engine is unavailable (the caller runs the Python search).

    The native search uses its own deterministic RNG, so the plan (and
    hence term counts) can differ from the pure-Python fallback's — both
    are valid matchings; regression pins run against the native path.
    """
    lib = _load()
    if lib is None:
        return None
    n = len(umask)
    n_coords = max(
        (x.bit_length() for x in umask + lhmask), default=1
    )
    w = max(1, (n_coords + 63) // 64)
    mask64 = (1 << 64) - 1

    def pack_into(arr, base, x):
        for k in range(w):
            arr[base + k] = (x >> (64 * k)) & mask64

    um = array("Q", bytes(8 * n * w))
    lm = array("Q", bytes(8 * n * w))
    for i in range(n):
        pack_into(um, i * w, umask[i])
        pack_into(lm, i * w, lhmask[i])
    dm = array("Q", bytes(8 * n * n * w))
    al = array("B", bytes(n * n))
    for (i, j) in allowed_set:
        al[i * n + j] = 1
        al[j * n + i] = 1
        pack_into(dm, (i * n + j) * w, dmask[(i, j)])
        pack_into(dm, (j * n + i) * w, dmask[(i, j)])
    out = array("q", bytes(8 * n))
    got = lib.zx_plan_cover(
        ctypes.cast(
            (ctypes.c_uint64 * len(um)).from_buffer(um),
            ctypes.POINTER(ctypes.c_uint64),
        ),
        ctypes.cast(
            (ctypes.c_uint64 * len(lm)).from_buffer(lm),
            ctypes.POINTER(ctypes.c_uint64),
        ),
        ctypes.cast(
            (ctypes.c_uint64 * len(dm)).from_buffer(dm),
            ctypes.POINTER(ctypes.c_uint64),
        ),
        ctypes.cast(
            (ctypes.c_uint8 * len(al)).from_buffer(al),
            ctypes.POINTER(ctypes.c_uint8),
        ),
        n,
        w,
        drop_w,
        budget,
        ctypes.cast(
            (ctypes.c_int64 * len(out)).from_buffer(out),
            ctypes.POINTER(ctypes.c_int64),
        ),
    )
    if got < 0:
        _fell_back()
        return None
    return [(int(out[2 * k]), int(out[2 * k + 1])) for k in range(got)]


def native_planned_enumerate(
    g: ZXGraph, pair_vertex_ids, assigns, shake: bool
) -> list[ZXGraph] | None:
    """Enumerate planned pair-projector leaves natively.

    ``pair_vertex_ids``: [(l1, h1, l2, h2), ...]; ``assigns``: iterable of
    branch-bit tuples (one bit per pair). Returns the nonzero fully-reduced
    leaves, or None when the native engine is unavailable/unsupported (the
    caller falls back to the Python per-leaf loop).
    """
    lib = _load()
    if lib is None:
        return None
    enc = _Encoder()
    try:
        encode_graph(g, enc)
    except (TypeError, OverflowError):
        _fell_back()
        return None
    if not enc.ok:
        _fell_back()
        return None
    n = len(enc.ints)
    nf = len(enc.floats)
    in_i = (ctypes.c_int64 * n).from_buffer(enc.ints)
    in_f = (ctypes.c_double * max(nf, 1)).from_buffer(
        enc.floats if nf else array("d", [0.0])
    )
    pair_arr = array("q", [x for p in pair_vertex_ids for x in p])
    asg_arr = array("q", [int(b) for row in assigns for b in row])
    n_pairs = len(pair_vertex_ids)
    n_assigns = len(asg_arr) // max(n_pairs, 1)
    pairs_c = (ctypes.c_int64 * len(pair_arr)).from_buffer(pair_arr)
    asg_c = (ctypes.c_int64 * max(len(asg_arr), 1)).from_buffer(
        asg_arr if asg_arr else array("q", [0])
    )
    out_i = ctypes.POINTER(ctypes.c_int64)()
    out_il = ctypes.c_int64()
    out_f = ctypes.POINTER(ctypes.c_double)()
    out_fl = ctypes.c_int64()
    status = lib.zx_planned_enumerate(
        ctypes.cast(in_i, ctypes.POINTER(ctypes.c_int64)),
        n,
        ctypes.cast(in_f, ctypes.POINTER(ctypes.c_double)),
        nf,
        1 if shake else 0,
        ctypes.cast(pairs_c, ctypes.POINTER(ctypes.c_int64)),
        n_pairs,
        ctypes.cast(asg_c, ctypes.POINTER(ctypes.c_int64)),
        n_assigns,
        ctypes.byref(out_i),
        ctypes.byref(out_il),
        ctypes.byref(out_f),
        ctypes.byref(out_fl),
    )
    if status != 0:
        _fell_back()
        return None
    try:
        ints = out_i[: out_il.value]
        floats = out_f[: out_fl.value]
        dec = _Decoder(ints, floats, enc.names)
        count = dec.next()
        leaves = []
        for _ in range(count):
            gg = ZXGraph()
            decode_graph(dec, gg)
            leaves.append(gg)
    finally:
        lib.zx_free_i64(out_i)
        lib.zx_free_f64(out_f)
    return leaves


def native_full_reduce(g: ZXGraph, shake: bool) -> bool:
    """Run the native full_reduce; returns False if unavailable/unsupported
    (``g`` untouched), True when ``g`` has been reduced in place."""
    lib = _load()
    if lib is None:
        return False
    enc = _Encoder()
    try:
        encode_graph(g, enc)
    except (TypeError, OverflowError):
        _fell_back()
        return False
    if not enc.ok:
        _fell_back()
        return False
    n = len(enc.ints)
    nf = len(enc.floats)
    in_i = (ctypes.c_int64 * n).from_buffer(enc.ints)
    in_f = (ctypes.c_double * max(nf, 1)).from_buffer(
        enc.floats if nf else array("d", [0.0])
    )
    out_i = ctypes.POINTER(ctypes.c_int64)()
    out_il = ctypes.c_int64()
    out_f = ctypes.POINTER(ctypes.c_double)()
    out_fl = ctypes.c_int64()
    status = lib.zx_full_reduce(
        ctypes.cast(in_i, ctypes.POINTER(ctypes.c_int64)),
        n,
        ctypes.cast(in_f, ctypes.POINTER(ctypes.c_double)),
        nf,
        1 if shake else 0,
        ctypes.byref(out_i),
        ctypes.byref(out_il),
        ctypes.byref(out_f),
        ctypes.byref(out_fl),
    )
    if status != 0:
        _fell_back()
        return False
    try:
        ints = out_i[: out_il.value]
        floats = out_f[: out_fl.value]
        decode_graph(_Decoder(ints, floats, enc.names), g)
    finally:
        lib.zx_free_i64(out_i)
        lib.zx_free_f64(out_f)
    return True
