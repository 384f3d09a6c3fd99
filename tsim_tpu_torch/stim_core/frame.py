"""Pauli-frame batch sampler + noiseless reference sampling.

The Clifford fast path / CPU baseline (the role Stim's frame simulator plays
for the reference, ``SURVEY.md`` section 2.1 row 1): a noiseless reference
sample from the tableau simulator, then vectorized per-shot X/Z frame
propagation with noise-driven flips. Also provides the measurement-to-
detection-events conversion used by ``compile_m2d_converter``.
"""

from __future__ import annotations

import numpy as np

from ..core.parse import _iter_pauli_products
from .circuit import Circuit
from .tableau import ACTIONS_1Q, ACTIONS_2Q, TableauSimulator, _BITS_OF_P


def reference_sample(circuit: Circuit, rng=None) -> np.ndarray:
    """Deterministic noiseless measurement sample (random outcomes -> 0)."""
    return _run_tableau_forced(circuit, None)


def _run_tableau_forced(circuit: Circuit, rng=None) -> np.ndarray:
    """Noiseless tableau run; non-deterministic outcomes forced to 0 (rng
    None) or to random bits drawn from ``rng``."""
    flat = circuit.without_noise().flattened()
    n = circuit.num_qubits
    sim = TableauSimulator(max(n, 1))
    rec: list[int] = []
    for instr in flat:
        name = instr.name
        targets = instr.targets_copy()
        if name in ("M", "MZ", "MX", "MY", "MR", "MRZ", "MRX", "MRY"):
            basis = name[-1] if name[-1] in "XY" else "Z"
            pre = {"Z": None, "X": "H", "Y": "H_YZ"}[basis]
            for t in targets:
                q = t.value
                if pre:
                    sim.apply_gate(pre, [q])
                want = 0 if rng is None else int(rng.integers(0, 2))
                out, det = sim.measure(q, forced=want)
                if name.startswith("MR"):
                    if out:
                        sim.apply_gate("X", [q])
                rec.append(out ^ int(t.is_inverted_result_target))
                if pre:
                    sim.apply_gate(pre, [q])
            continue
        if name in ("MXX", "MYY", "MZZ"):
            pl = name[1]
            for i in range(0, len(targets), 2):
                t0, t1 = targets[i], targets[i + 1]
                want = 0 if rng is None else int(rng.integers(0, 2))
                out, det = sim.measure_pauli_product(
                    [(pl, t0.value), (pl, t1.value)], forced=want
                )
                if not det:
                    out = want
                rec.append(
                    out
                    ^ int(t0.is_inverted_result_target)
                    ^ int(t1.is_inverted_result_target)
                )
            continue
        if name == "MPP":
            for paulis, invert in _iter_pauli_products(instr):
                want = 0 if rng is None else int(rng.integers(0, 2))
                out, det = sim.measure_pauli_product(paulis, forced=want)
                if not det:
                    out = want
                rec.append(out ^ int(invert))
            continue
        if name == "MPAD":
            for t in targets:
                rec.append(int(t.value))
            continue
        if name in ("R", "RZ"):
            for t in targets:
                sim.reset(t.value)
            continue
        if name == "RX":
            for t in targets:
                sim.reset(t.value)
                sim.apply_gate("H", [t.value])
            continue
        if name == "RY":
            for t in targets:
                sim.reset(t.value)
                sim.apply_gate("H_YZ", [t.value])
            continue
        if name in ("SPP", "SPP_DAG"):
            raise ValueError("reference_sample requires a Clifford circuit (SPP unsupported here)")
        if name in ("DETECTOR", "OBSERVABLE_INCLUDE", "TICK", "QUBIT_COORDS",
                    "SHIFT_COORDS", "I", "II", "MPAD"):
            continue
        if name in ACTIONS_1Q:
            for t in targets:
                sim.apply_gate(name, [t.value])
            continue
        if name in ACTIONS_2Q:
            for i in range(0, len(targets), 2):
                t0, t1 = targets[i], targets[i + 1]
                if t0.is_measurement_record_target or t1.is_measurement_record_target:
                    # classically controlled Pauli by a reference bit
                    _apply_rec_controlled_tableau(sim, name, t0, t1, rec)
                else:
                    sim.apply_gate(name, [t0.value, t1.value])
            continue
        raise ValueError(f"reference_sample cannot execute: {name}")
    return np.array(rec, dtype=bool)


def _apply_rec_controlled_tableau(sim, name, t0, t1, rec):
    base = name.upper()
    if base in ("XCZ", "YCZ"):
        t0, t1 = t1, t0
        base = {"XCZ": "CX", "YCZ": "CY"}[base]
    if t1.is_measurement_record_target and base in ("CZ", "ZCZ"):
        t0, t1 = t1, t0
    assert t0.is_measurement_record_target
    if rec[t0.value]:
        pl = {"CX": "X", "CNOT": "X", "ZCX": "X", "CY": "Y", "ZCY": "Y",
              "CZ": "Z", "ZCZ": "Z"}[base]
        sim.apply_gate(pl, [t1.value])


class FrameSampler:
    """Vectorized Pauli-frame sampling over a batch of shots.

    Requires a Clifford circuit. Noise flips frames; measurements report
    ``reference XOR frame``; detectors/observables XOR recorded bits.
    """

    def __init__(self, circuit: Circuit, seed: int | None = None):
        self.circuit = circuit._stim_circ if hasattr(circuit, "_stim_circ") else circuit
        self.flat = self.circuit.flattened()
        self.n = self.circuit.num_qubits
        self.ref = reference_sample(self.circuit)
        self.rng = np.random.default_rng(seed)

    def sample(self, shots: int):
        """Returns (measurements, detectors, observables) bool arrays."""
        n = max(self.n, 1)
        rng = self.rng

        def rand_bits():
            return rng.integers(0, 2, shots, dtype=np.uint8).astype(bool)

        # Qubits start reset: the Z-stabilizer gauge direction is random.
        # This is what turns into genuine measurement randomness downstream
        # (e.g. H then M samples 50/50 because the random fz becomes fx).
        fx = np.zeros((shots, n), dtype=bool)
        fz = np.stack([rand_bits() for _ in range(n)], axis=1)
        rec: list[np.ndarray] = []
        dets: list[np.ndarray] = []
        obs: dict[int, np.ndarray] = {}
        num_obs = self.circuit.num_observables
        for k in range(num_obs):
            obs[k] = np.zeros(shots, dtype=bool)
        prev_corr_fired = np.zeros(shots, dtype=bool)
        ref_idx = 0

        def frame_gate_1q(name, q):
            act = ACTIONS_1Q[name]
            bx = _BITS_OF_P[act["X"][1]]
            bz = _BITS_OF_P[act["Z"][1]]
            nfx = (fx[:, q] & bx[0]) ^ (fz[:, q] & bz[0])
            nfz = (fx[:, q] & bx[1]) ^ (fz[:, q] & bz[1])
            fx[:, q], fz[:, q] = nfx, nfz

        def frame_gate_2q(name, q1, q2):
            act = ACTIONS_2Q[name]
            comps = {
                ("X", "I"): fx[:, q1].copy(),
                ("Z", "I"): fz[:, q1].copy(),
                ("I", "X"): fx[:, q2].copy(),
                ("I", "Z"): fz[:, q2].copy(),
            }
            nx1 = np.zeros(shots, dtype=bool)
            nz1 = np.zeros(shots, dtype=bool)
            nx2 = np.zeros(shots, dtype=bool)
            nz2 = np.zeros(shots, dtype=bool)
            for key, present in comps.items():
                _, names = act[key]
                b1 = _BITS_OF_P[names[0]]
                b2 = _BITS_OF_P[names[1]]
                if b1[0]:
                    nx1 ^= present
                if b1[1]:
                    nz1 ^= present
                if b2[0]:
                    nx2 ^= present
                if b2[1]:
                    nz2 ^= present
            fx[:, q1], fz[:, q1] = nx1, nz1
            fx[:, q2], fz[:, q2] = nx2, nz2

        for instr in self.flat:
            name = instr.name
            targets = instr.targets_copy()
            args = instr.gate_args_copy()

            if name in ("M", "MZ", "MX", "MY", "MR", "MRZ", "MRX", "MRY"):
                p = args[0] if args else 0.0
                basis = name[-1] if name[-1] in "XY" else "Z"
                for t in targets:
                    q = t.value
                    if basis == "X":
                        bit = fz[:, q].copy()
                    elif basis == "Y":
                        bit = fx[:, q] ^ fz[:, q]
                    else:
                        bit = fx[:, q].copy()
                    out = self.ref[ref_idx] ^ bit
                    if p:
                        out ^= rng.random(shots) < p
                    rec.append(out)
                    ref_idx += 1
                    if name.startswith("MR"):
                        if basis == "Z":
                            fx[:, q] = False
                            fz[:, q] = rand_bits()
                        elif basis == "X":
                            fz[:, q] = False
                            fx[:, q] = rand_bits()
                        else:
                            r = rand_bits()
                            fx[:, q] = r
                            fz[:, q] = r
                    elif basis == "Z":
                        fz[:, q] = rand_bits()
                    elif basis == "X":
                        fx[:, q] = rand_bits()
                    else:
                        r = rand_bits()
                        fx[:, q] ^= r
                        fz[:, q] ^= r
                continue
            if name in ("MXX", "MYY", "MZZ"):
                p = args[0] if args else 0.0
                pl = name[1]
                for i in range(0, len(targets), 2):
                    q0, q1 = targets[i].value, targets[i + 1].value
                    if pl == "X":
                        bit = fz[:, q0] ^ fz[:, q1]
                    elif pl == "Y":
                        bit = fx[:, q0] ^ fz[:, q0] ^ fx[:, q1] ^ fz[:, q1]
                    else:
                        bit = fx[:, q0] ^ fx[:, q1]
                    out = self.ref[ref_idx] ^ bit
                    if p:
                        out ^= rng.random(shots) < p
                    rec.append(out)
                    ref_idx += 1
                    # Randomize the measured product's gauge direction.
                    r = rand_bits()
                    for q in (q0, q1):
                        if pl in ("X", "Y"):
                            fx[:, q] ^= r
                        if pl in ("Z", "Y"):
                            fz[:, q] ^= r
                continue
            if name == "MPP":
                p = args[0] if args else 0.0
                for paulis, invert in _iter_pauli_products(instr):
                    bit = np.zeros(shots, dtype=bool)
                    for pl, q in paulis:
                        if pl == "X":
                            bit ^= fz[:, q]
                        elif pl == "Y":
                            bit ^= fx[:, q] ^ fz[:, q]
                        else:
                            bit ^= fx[:, q]
                    out = self.ref[ref_idx] ^ bit
                    if p:
                        out ^= rng.random(shots) < p
                    rec.append(out)
                    ref_idx += 1
                    r = rand_bits()
                    for pl, q in paulis:
                        if pl in ("X", "Y"):
                            fx[:, q] ^= r
                        if pl in ("Z", "Y"):
                            fz[:, q] ^= r
                continue
            if name == "MPAD":
                p = args[0] if args else 0.0
                for t in targets:
                    out = np.full(shots, bool(self.ref[ref_idx]))
                    if p:
                        out = out ^ (rng.random(shots) < p)
                    rec.append(out)
                    ref_idx += 1
                continue
            if name in ("R", "RZ", "RX", "RY"):
                for t in targets:
                    q = t.value
                    if name in ("R", "RZ"):
                        fx[:, q] = False
                        fz[:, q] = rand_bits()
                    elif name == "RX":
                        fz[:, q] = False
                        fx[:, q] = rand_bits()
                    else:
                        r = rand_bits()
                        fx[:, q] = r
                        fz[:, q] = r
                continue
            if name == "X_ERROR":
                for t in targets:
                    fx[:, t.value] ^= rng.random(shots) < args[0]
                continue
            if name == "Z_ERROR":
                for t in targets:
                    fz[:, t.value] ^= rng.random(shots) < args[0]
                continue
            if name == "Y_ERROR":
                for t in targets:
                    flip = rng.random(shots) < args[0]
                    fx[:, t.value] ^= flip
                    fz[:, t.value] ^= flip
                continue
            if name == "DEPOLARIZE1":
                for t in targets:
                    r = rng.random(shots)
                    p3 = args[0] / 3
                    fx[:, t.value] ^= (r < p3) | ((r >= p3) & (r < 2 * p3))
                    fz[:, t.value] ^= (r >= p3) & (r < 3 * p3) | ((r >= p3) & (r < 2 * p3))
                continue
            if name == "DEPOLARIZE2":
                for i in range(0, len(targets), 2):
                    q0, q1 = targets[i].value, targets[i + 1].value
                    r = rng.random(shots)
                    fired = r < args[0]
                    which = rng.integers(1, 16, shots)
                    for bit_idx, arr, q in (
                        (0, fz, q0), (1, fx, q0), (2, fz, q1), (3, fx, q1),
                    ):
                        arr[:, q] ^= fired & (((which >> bit_idx) & 1) == 1)
                continue
            if name == "PAULI_CHANNEL_1":
                px, py, pz = args
                for t in targets:
                    r = rng.random(shots)
                    x_f = (r < px) | ((r >= px) & (r < px + py))
                    z_f = ((r >= px) & (r < px + py + pz))
                    fx[:, t.value] ^= x_f
                    fz[:, t.value] ^= z_f
                continue
            if name == "PAULI_CHANNEL_2":
                bit_layout = []
                for pa in ("I", "X", "Y", "Z"):
                    for pb in ("I", "X", "Y", "Z"):
                        if (pa, pb) != ("I", "I"):
                            bit_layout.append((pa, pb))
                for i in range(0, len(targets), 2):
                    q0, q1 = targets[i].value, targets[i + 1].value
                    r = rng.random(shots)
                    acc = np.zeros(shots)
                    chosen = np.full(shots, -1)
                    for idx, p in enumerate(args):
                        newacc = acc + p
                        sel = (r >= acc) & (r < newacc)
                        chosen[sel] = idx
                        acc = newacc
                    for idx, (pa, pb) in enumerate(bit_layout):
                        sel = chosen == idx
                        if not sel.any():
                            continue
                        if pa in ("X", "Y"):
                            fx[sel, q0] ^= True
                        if pa in ("Z", "Y"):
                            fz[sel, q0] ^= True
                        if pb in ("X", "Y"):
                            fx[sel, q1] ^= True
                        if pb in ("Z", "Y"):
                            fz[sel, q1] ^= True
                continue
            if name in ("HERALDED_ERASE", "HERALDED_PAULI_CHANNEL_1"):
                probs = (
                    [args[0] / 4] * 4
                    if name == "HERALDED_ERASE"
                    else list(args)
                )
                for t in targets:
                    q = t.value
                    r = rng.random(shots)
                    acc = 0.0
                    herald = np.zeros(shots, dtype=bool)
                    for pl, p in zip(["I", "X", "Y", "Z"], probs):
                        sel = (r >= acc) & (r < acc + p)
                        acc += p
                        herald |= sel
                        if pl in ("X", "Y"):
                            fx[sel, q] ^= True
                        if pl in ("Z", "Y"):
                            fz[sel, q] ^= True
                    rec.append(herald)
                    ref_idx += 1
                continue
            if name in ("E", "CORRELATED_ERROR", "ELSE_CORRELATED_ERROR"):
                if name != "ELSE_CORRELATED_ERROR":
                    prev_corr_fired[:] = False
                fire = (~prev_corr_fired) & (rng.random(shots) < args[0])
                prev_corr_fired |= fire
                for t in targets:
                    if t.pauli_type in ("X", "Y"):
                        fx[fire, t.value] ^= True
                    if t.pauli_type in ("Z", "Y"):
                        fz[fire, t.value] ^= True
                continue
            if name == "DETECTOR":
                val = np.zeros(shots, dtype=bool)
                for t in targets:
                    val ^= rec[t.value]
                # detection events are deviations from the reference
                ref_val = False
                for t in targets:
                    ref_val ^= bool(self.ref[len(rec) + t.value])
                dets.append(val ^ ref_val)
                continue
            if name == "OBSERVABLE_INCLUDE":
                idx = int(args[0])
                for t in targets:
                    obs[idx] ^= rec[t.value]
                continue
            if name in ("TICK", "QUBIT_COORDS", "SHIFT_COORDS", "I", "II",
                        "I_ERROR", "II_ERROR"):
                continue
            if name in ACTIONS_1Q:
                for t in targets:
                    frame_gate_1q(name, t.value)
                continue
            if name in ACTIONS_2Q:
                for i in range(0, len(targets), 2):
                    t0, t1 = targets[i], targets[i + 1]
                    if t0.is_measurement_record_target or t1.is_measurement_record_target:
                        self._rec_controlled(name, t0, t1, rec, fx, fz)
                    else:
                        frame_gate_2q(name, t0.value, t1.value)
                continue
            raise ValueError(f"FrameSampler cannot execute: {name}")

        m = np.stack(rec, axis=1) if rec else np.zeros((shots, 0), dtype=bool)
        d = np.stack(dets, axis=1) if dets else np.zeros((shots, 0), dtype=bool)
        o = (
            np.stack([obs[k] for k in sorted(obs)], axis=1)
            if obs
            else np.zeros((shots, 0), dtype=bool)
        )
        return m, d, o

    def _rec_controlled(self, name, t0, t1, rec, fx, fz):
        base = name.upper()
        if base in ("XCZ", "YCZ"):
            t0, t1 = t1, t0
            base = {"XCZ": "CX", "YCZ": "CY"}[base]
        if t1.is_measurement_record_target and base in ("CZ", "ZCZ"):
            t0, t1 = t1, t0
        assert t0.is_measurement_record_target
        ctrl_frame = rec[t0.value] ^ bool(self.ref[len(rec) + t0.value])
        pl = {"CX": "X", "CNOT": "X", "ZCX": "X", "CY": "Y", "ZCY": "Y",
              "CZ": "Z", "ZCZ": "Z"}[base]
        q = t1.value
        if pl in ("X", "Y"):
            fx[:, q] ^= ctrl_frame
        if pl in ("Z", "Y"):
            fz[:, q] ^= ctrl_frame
