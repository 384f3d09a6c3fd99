"""Native bit-packed Pauli-frame sampler (C++ backend).

Compiles a Clifford circuit into a flat op stream executed by
``native/src/frame_kernels.cpp``: frames are packed 64 shots per word,
gates are word-wide XORs, and every noise channel is drawn by geometric
skipping, so sampling cost scales with fired errors instead of
shots x channels — the design Stim's C++ core uses for the reference
(SURVEY.md section 2.1 row 1). Semantics match ``frame.FrameSampler``
exactly (same gauge-randomization rules); RNG streams differ.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..core.parse import _iter_pauli_products
from .circuit import Circuit
from .frame import reference_sample
from .tableau import ACTIONS_1Q, ACTIONS_2Q, _BITS_OF_P

(
    OP_GATE1, OP_GATE2, OP_MEAS, OP_GAUGE_SET, OP_GAUGE_PROD, OP_ERR1,
    OP_DEP1, OP_DEP2, OP_PC1, OP_PC2, OP_HERALD, OP_CORR, OP_DET, OP_OBS,
    OP_RC_PAULI,
) = range(15)

_MEAS_MASK = {"Z": 1, "X": 2, "Y": 3}   # which frame rows flip the outcome
_GAUGE_MASK = {"X": 1, "Y": 3, "Z": 2}  # which frame rows the gauge word hits
_PAULI_MASK = {"X": 1, "Y": 3, "Z": 2}
_GAUGE_SET_RESET = {"Z": 0, "X": 1, "Y": 2}
_GAUGE_SET_MEAS = {"Z": 3, "X": 4, "Y": 5}


def _gate1_bits(name: str) -> int:
    act = ACTIONS_1Q[name]
    bx = _BITS_OF_P[act["X"][1]]
    bz = _BITS_OF_P[act["Z"][1]]
    return bx[0] | (bz[0] << 1) | (bx[1] << 2) | (bz[1] << 3)


def _gate2_bits(name: str) -> int:
    act = ACTIONS_2Q[name]
    cols = [("X", "I"), ("Z", "I"), ("I", "X"), ("I", "Z")]  # x1 z1 x2 z2
    bits = 0
    for c, key in enumerate(cols):
        _, names = act[key]
        b1 = _BITS_OF_P[names[0]]
        b2 = _BITS_OF_P[names[1]]
        for r, v in enumerate((b1[0], b1[1], b2[0], b2[1])):
            if v:
                bits |= 1 << (r * 4 + c)
    return bits


class _OpWriter:
    def __init__(self):
        self.ops: list[tuple[int, int, int, int, int, int, int]] = []
        self.aux: list[int] = []
        self.dargs: list[float] = [0.0]  # index 0 = "no probability args"

    def emit(self, op, a=0, b=0, c=0, aux=(), dargs=()):
        aux_off = len(self.aux)
        self.aux.extend(int(v) for v in aux)
        if dargs:
            d_off = len(self.dargs)
            self.dargs.extend(float(v) for v in dargs)
        else:
            d_off = 0
        if op in (OP_MEAS, OP_GAUGE_PROD, OP_CORR):
            aux_n = len(aux) // 2  # (qubit, mask) pairs
        else:
            aux_n = len(aux)  # record indices (DET/OBS) or unused
        self.ops.append((op, int(a), int(b), int(c), aux_off, aux_n, d_off))


class NativeFrameSampler:
    """Drop-in counterpart of ``frame.FrameSampler`` backed by C++."""

    def __init__(
        self,
        circuit: Circuit,
        seed: int | None = None,
        det_bias: np.ndarray | None = None,
    ):
        """``det_bias``: optional (num_detectors,) 0/1 row XORed into every
        detector output at op-compile time (used by the sampler to convert
        stim-style flips to absolute detector values without an extra
        full-array XOR pass over multi-GB outputs)."""
        from ..native.build import load_library

        self.circuit = (
            circuit._stim_circ if hasattr(circuit, "_stim_circ") else circuit
        )
        self._lib = load_library("frame_kernels")
        fn = self._lib.tsim_frame_run
        fn.restype = None
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double),
            ctypes.c_uint64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        tr = self._lib.tsim_bit_transpose
        tr.restype = None
        tr.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
        ]
        up = self._lib.tsim_unpack_rows
        up.restype = None
        up.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ]
        self._rng = np.random.default_rng(seed)
        self._det_bias = (
            None if det_bias is None else np.asarray(det_bias).astype(np.uint8)
        )
        self._buf_pool: dict[tuple, list[np.ndarray]] = {}
        self.ref = reference_sample(self.circuit)
        self.n = max(self.circuit.num_qubits, 1)
        self.num_obs = self.circuit.num_observables
        self._compile()

    # ------------------------------------------------------------- compile
    def _compile(self) -> None:
        w = _OpWriter()
        ref = self.ref
        ref_idx = 0
        num_det = 0

        for instr in self.circuit.flattened():
            name = instr.name
            targets = instr.targets_copy()
            args = instr.gate_args_copy()

            if name in ("M", "MZ", "MX", "MY", "MR", "MRZ", "MRX", "MRY"):
                p = args[0] if args else 0.0
                basis = name[-1] if name[-1] in "XY" else "Z"
                reset = name.startswith("MR")
                for t in targets:
                    q = t.value
                    w.emit(OP_MEAS, ref_idx, int(ref[ref_idx]),
                           aux=(q, _MEAS_MASK[basis]), dargs=(p,))
                    ref_idx += 1
                    mode = (_GAUGE_SET_RESET if reset else _GAUGE_SET_MEAS)[basis]
                    w.emit(OP_GAUGE_SET, q, mode)
                continue
            if name in ("MXX", "MYY", "MZZ"):
                p = args[0] if args else 0.0
                pl = name[1]
                for i in range(0, len(targets), 2):
                    q0, q1 = targets[i].value, targets[i + 1].value
                    mm = _MEAS_MASK[pl]
                    w.emit(OP_MEAS, ref_idx, int(ref[ref_idx]),
                           aux=(q0, mm, q1, mm), dargs=(p,))
                    ref_idx += 1
                    gm = _GAUGE_MASK[pl]
                    w.emit(OP_GAUGE_PROD, aux=(q0, gm, q1, gm))
                continue
            if name == "MPP":
                p = args[0] if args else 0.0
                for paulis, _invert in _iter_pauli_products(instr):
                    maux, gaux = [], []
                    for pl, q in paulis:
                        maux += [q, _MEAS_MASK[pl]]
                        gaux += [q, _GAUGE_MASK[pl]]
                    w.emit(OP_MEAS, ref_idx, int(ref[ref_idx]), aux=maux,
                           dargs=(p,))
                    ref_idx += 1
                    w.emit(OP_GAUGE_PROD, aux=gaux)
                continue
            if name == "MPAD":
                p = args[0] if args else 0.0
                for _t in targets:
                    w.emit(OP_MEAS, ref_idx, int(ref[ref_idx]), dargs=(p,))
                    ref_idx += 1
                continue
            if name in ("R", "RZ", "RX", "RY"):
                basis = name[-1] if name[-1] in "XY" else "Z"
                for t in targets:
                    w.emit(OP_GAUGE_SET, t.value, _GAUGE_SET_RESET[basis])
                continue
            if name in ("X_ERROR", "Y_ERROR", "Z_ERROR"):
                mask = _PAULI_MASK[name[0]]
                for t in targets:
                    w.emit(OP_ERR1, t.value, mask, dargs=(args[0],))
                continue
            if name == "DEPOLARIZE1":
                for t in targets:
                    w.emit(OP_DEP1, t.value, dargs=(args[0],))
                continue
            if name == "DEPOLARIZE2":
                for i in range(0, len(targets), 2):
                    w.emit(OP_DEP2, targets[i].value, targets[i + 1].value,
                           dargs=(args[0],))
                continue
            if name == "PAULI_CHANNEL_1":
                for t in targets:
                    w.emit(OP_PC1, t.value, dargs=tuple(args))
                continue
            if name == "PAULI_CHANNEL_2":
                for i in range(0, len(targets), 2):
                    w.emit(OP_PC2, targets[i].value, targets[i + 1].value,
                           dargs=tuple(args))
                continue
            if name in ("HERALDED_ERASE", "HERALDED_PAULI_CHANNEL_1"):
                probs = (
                    [args[0] / 4] * 4 if name == "HERALDED_ERASE" else list(args)
                )
                for t in targets:
                    w.emit(OP_HERALD, ref_idx, t.value, dargs=tuple(probs))
                    ref_idx += 1
                continue
            if name in ("E", "CORRELATED_ERROR", "ELSE_CORRELATED_ERROR"):
                aux = []
                for t in targets:
                    aux += [t.value, _PAULI_MASK[t.pauli_type]]
                w.emit(OP_CORR, c=int(name != "ELSE_CORRELATED_ERROR"),
                       aux=aux, dargs=(args[0],))
                continue
            if name == "DETECTOR":
                idxs = [ref_idx + t.value for t in targets]
                ref_par = 0
                for j in idxs:
                    ref_par ^= int(ref[j])
                if self._det_bias is not None and num_det < len(self._det_bias):
                    ref_par ^= int(self._det_bias[num_det])
                w.emit(OP_DET, num_det, ref_par, aux=idxs)
                num_det += 1
                continue
            if name == "OBSERVABLE_INCLUDE":
                w.emit(OP_OBS, int(args[0]),
                       aux=[ref_idx + t.value for t in targets])
                continue
            if name in ("TICK", "QUBIT_COORDS", "SHIFT_COORDS", "I", "II",
                        "I_ERROR", "II_ERROR"):
                continue
            if name in ACTIONS_1Q:
                bits = _gate1_bits(name)
                for t in targets:
                    w.emit(OP_GATE1, t.value, bits)
                continue
            if name in ACTIONS_2Q:
                bits = None
                for i in range(0, len(targets), 2):
                    t0, t1 = targets[i], targets[i + 1]
                    if (t0.is_measurement_record_target
                            or t1.is_measurement_record_target):
                        self._emit_rec_controlled(w, name, t0, t1, ref_idx)
                    else:
                        if bits is None:
                            bits = _gate2_bits(name)
                        w.emit(OP_GATE2, t0.value, t1.value, bits)
                continue
            raise ValueError(f"NativeFrameSampler cannot execute: {name}")

        self.num_meas = ref_idx
        self.num_det = num_det
        self._ops = np.array(w.ops, dtype=np.int32).reshape(-1, 7)
        self._aux = np.array(w.aux or [0], dtype=np.int32)
        self._dargs = np.array(w.dargs, dtype=np.float64)

    def _emit_rec_controlled(self, w, name, t0, t1, ref_idx) -> None:
        base = name.upper()
        if base in ("XCZ", "YCZ"):
            t0, t1 = t1, t0
            base = {"XCZ": "CX", "YCZ": "CY"}[base]
        if t1.is_measurement_record_target and base in ("CZ", "ZCZ"):
            t0, t1 = t1, t0
        assert t0.is_measurement_record_target
        pl = {"CX": "X", "CNOT": "X", "ZCX": "X", "CY": "Y", "ZCY": "Y",
              "CZ": "Z", "ZCZ": "Z"}[base]
        rec_abs = ref_idx + t0.value
        ref_bit = int(self.ref[rec_abs])
        w.emit(OP_RC_PAULI, t1.value, rec_abs,
               _PAULI_MASK[pl] | (ref_bit << 2))

    # -------------------------------------------------------------- sample
    def sample(
        self,
        shots: int,
        *,
        bit_packed: bool = False,
        include_measurements: bool = True,
    ):
        """Returns (measurements, detectors, observables).

        Bool arrays of shape (shots, n); with ``bit_packed`` the packed
        uint8 little-endian rows (shots, ceil(n/8)) are returned instead.
        ``include_measurements=False`` skips the measurement-record
        transpose/unpack (the dominant cost for detector sampling) and
        returns ``None`` in its slot.
        """
        rec, dets, obs = self._run(shots)
        return (
            self._unpack(rec, self.num_meas, shots, bit_packed)
            if include_measurements
            else None,
            self._unpack(dets, self.num_det, shots, bit_packed),
            self._unpack(obs, self.num_obs, shots, bit_packed),
        )

    def _out_buffer(self, shots: int, cols: int) -> np.ndarray:
        """(shots, cols) bool output buffer, recycled across calls.

        First-touch page faults on fresh multi-GB allocations dominate
        end-to-end Clifford sampling on some hosts (measured 0.15 GB/s
        faulting vs 2+ GB/s on warm pages for the d=7 workload): keep the
        last two returned arrays per shape and reuse any the caller no
        longer references (refcount == pool entry + loop local +
        getrefcount argument)."""
        import sys

        pool = self._buf_pool.setdefault((shots, cols), [])
        for a in pool:
            if sys.getrefcount(a) <= 3:
                return a
        a = np.empty((shots, cols), dtype=np.bool_)
        pool.append(a)
        del pool[:-2]
        return a

    def sample_det_obs_joined(self, shots: int) -> np.ndarray:
        """(shots, num_det + num_obs) bool — detectors and observables
        expanded into ONE output array (single allocation + single pass;
        the separate-then-concatenate layout costs two extra passes over
        multi-GB arrays at benchmark shot counts). The returned array may
        be a recycled buffer: it is only rewritten once the caller drops
        every reference to it."""
        total = self.num_det + self.num_obs
        if total == 0:
            return np.empty((shots, 0), dtype=np.bool_)
        _, dets, obs = self._run(shots)
        out = self._out_buffer(shots, total)
        u8 = out.view(np.uint8)
        self._unpack_into(dets, self.num_det, shots, u8, 0)
        self._unpack_into(obs, self.num_obs, shots, u8, self.num_det)
        return out

    def _run(self, shots: int):
        W = (shots + 63) >> 6
        rec = np.zeros((max(self.num_meas, 1), W), dtype=np.uint64)
        dets = np.zeros((max(self.num_det, 1), W), dtype=np.uint64)
        obs = np.zeros((max(self.num_obs, 1), W), dtype=np.uint64)
        seed = int(self._rng.integers(0, 2**63))
        i32p = ctypes.POINTER(ctypes.c_int32)
        self._lib.tsim_frame_run(
            self._ops.ctypes.data_as(i32p), len(self._ops),
            self._aux.ctypes.data_as(i32p),
            self._dargs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            seed, shots, self.n, self.num_meas, self.num_det, self.num_obs,
            rec.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            dets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            obs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        )
        return rec, dets, obs

    def _unpack_into(self, packed, n_rows, shots, out_u8, col0) -> None:
        """Expand packed bit rows into columns [col0, col0+n_rows) of the
        C-contiguous uint8 array ``out_u8``."""
        if n_rows == 0:
            return
        base = ctypes.cast(
            out_u8.ctypes.data + col0, ctypes.POINTER(ctypes.c_uint8)
        )
        self._lib.tsim_unpack_rows(
            packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            n_rows, packed.shape[1], shots, base, out_u8.shape[1],
        )

    def _unpack(self, packed, n_rows, shots, bit_packed):
        if n_rows == 0:
            if bit_packed:
                return np.zeros((shots, 0), dtype=np.uint8)
            return np.zeros((shots, 0), dtype=bool)
        W = packed.shape[1]
        u64p = ctypes.POINTER(ctypes.c_uint64)
        if not bit_packed:
            # Fused C transpose + spread-LUT expansion straight to the
            # (shots, n_rows) boolean layout; np.unpackbits on the packed
            # rows ran ~10x slower than memory bandwidth. The buffer is
            # recycled (see _out_buffer).
            out = self._out_buffer(shots, n_rows)
            self._unpack_into(packed, n_rows, shots, out.view(np.uint8), 0)
            return out
        stride = (n_rows + 63) >> 6  # words per shot-major row
        out = np.zeros((W * 64, stride), dtype=np.uint64)
        self._lib.tsim_bit_transpose(
            packed.ctypes.data_as(u64p), n_rows, W,
            out.ctypes.data_as(u64p), stride,
        )
        row_bytes = (n_rows + 7) >> 3
        return np.ascontiguousarray(
            out.view(np.uint8).reshape(W * 64, stride * 8)[:shots, :row_bytes]
        )
