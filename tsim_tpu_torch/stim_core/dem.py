"""Detector error models: data model + derivation from noisy circuits.

In-house replacement for Stim's DEM machinery (reference ``SURVEY.md``
section 2.1 row 1). The derivation walks the circuit BACKWARD once,
maintaining per-qubit X/Z sensitivity bitmasks over detectors+observables,
so each noise mechanism's symptom set is read off in O(1) at its site.

Supported: all Pauli/measurement-flip/heralded/correlated noise; exact
independent-q conversion for DEPOLARIZE1/2; disjoint channels under
``approximate_disjoint_errors``; gauge detectors via randomized tableau
probing (error(0.5) statements).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..core.parse import _iter_pauli_products
from .circuit import Circuit
from .tableau import ACTIONS_1Q, ACTIONS_2Q, _BITS_OF_P


# ---------------------------------------------------------------- data model
@dataclass(frozen=True)
class DemTarget:
    kind: str  # "D", "L", "^"
    val: int = 0

    def is_relative_detector_id(self) -> bool:
        return self.kind == "D"

    def is_logical_observable_id(self) -> bool:
        return self.kind == "L"

    def is_separator(self) -> bool:
        return self.kind == "^"

    def __str__(self) -> str:
        return "^" if self.kind == "^" else f"{self.kind}{self.val}"


def target_relative_detector_id(k: int) -> DemTarget:
    return DemTarget("D", k)


def target_logical_observable_id(k: int) -> DemTarget:
    return DemTarget("L", k)


def target_separator() -> DemTarget:
    return DemTarget("^")


@dataclass
class DemInstruction:
    type: str  # "error" | "detector" | "logical_observable"
    args: list[float] = field(default_factory=list)
    targets: list[DemTarget] = field(default_factory=list)

    def args_copy(self) -> list[float]:
        return list(self.args)

    def targets_copy(self) -> list[DemTarget]:
        return list(self.targets)

    def __str__(self) -> str:
        args = f"({', '.join(_fmt(a) for a in self.args)})" if self.args else ""
        tgt = " ".join(str(t) for t in self.targets)
        return f"{self.type}{args} {tgt}".rstrip()


def _fmt(a: float) -> str:
    return str(int(a)) if a == int(a) else repr(a)


class DetectorErrorModel:
    def __init__(self, text: str = ""):
        self.instructions: list[DemInstruction] = []
        if text:
            for line in text.splitlines():
                line = line.split("#", 1)[0].strip()
                if line:
                    self.instructions.append(_parse_dem_line(line))

    def append(self, instruction: DemInstruction) -> None:
        self.instructions.append(instruction)

    def __iter__(self):
        return iter(self.instructions)

    def __len__(self) -> int:
        return len(self.instructions)

    def __eq__(self, other) -> bool:
        if not isinstance(other, DetectorErrorModel):
            return NotImplemented
        return str(self) == str(other)

    @property
    def num_detectors(self) -> int:
        n = 0
        for ins in self.instructions:
            for t in ins.targets:
                if t.kind == "D":
                    n = max(n, t.val + 1)
        return n

    @property
    def num_observables(self) -> int:
        n = 0
        for ins in self.instructions:
            for t in ins.targets:
                if t.kind == "L":
                    n = max(n, t.val + 1)
        return n

    def approx_equals(self, other, *, atol: float) -> bool:
        if len(self.instructions) != len(other.instructions):
            return False
        for a, b in zip(self.instructions, other.instructions):
            if a.type != b.type or a.targets != b.targets:
                return False
            if len(a.args) != len(b.args):
                return False
            if any(abs(x - y) > atol for x, y in zip(a.args, b.args)):
                return False
        return True

    def __str__(self) -> str:
        return "\n".join(str(i) for i in self.instructions)

    def __repr__(self) -> str:
        return f"DetectorErrorModel('''\n{self}\n''')"


def _parse_dem_line(line: str) -> DemInstruction:
    import re

    m = re.match(r"^(\w+)(?:\(([^)]*)\))?\s*(.*)$", line)
    assert m, line
    name, args, rest = m.groups()
    arglist = [float(x) for x in args.split(",")] if args else []
    targets = []
    for tok in rest.split():
        if tok == "^":
            targets.append(target_separator())
        elif tok[0] == "D":
            targets.append(target_relative_detector_id(int(tok[1:])))
        elif tok[0] == "L":
            targets.append(target_logical_observable_id(int(tok[1:])))
        else:
            raise ValueError(f"bad DEM target {tok}")
    return DemInstruction(name, arglist, targets)


# ------------------------------------------------------------- derivation
class _Sensitivity:
    """Per-qubit X/Z symptom bitmasks over detectors(0..D-1)+observables(D..)."""

    def __init__(self, n: int):
        self.x = [0] * n  # symptoms flipped by an X error on qubit q "now"
        self.z = [0] * n

    def pauli_mask(self, pauli: str, q: int) -> int:
        if pauli == "X":
            return self.x[q]
        if pauli == "Z":
            return self.z[q]
        return self.x[q] ^ self.z[q]


def _gate_backward(sens: _Sensitivity, name: str, qubits: list[int]) -> None:
    """Pull sensitivity backward through a Clifford gate.

    An error P before U equals the error U P U^dag after U, so
    sens_before(P) = sens_after(U P U^dag).
    """
    if len(qubits) == 1:
        act = ACTIONS_1Q[name]
        (q,) = qubits
        bx = _BITS_OF_P[act["X"][1]]
        bz = _BITS_OF_P[act["Z"][1]]
        new_x = (sens.x[q] if bx[0] else 0) ^ (sens.z[q] if bx[1] else 0)
        new_z = (sens.x[q] if bz[0] else 0) ^ (sens.z[q] if bz[1] else 0)
        sens.x[q], sens.z[q] = new_x, new_z
        return
    act = ACTIONS_2Q[name]
    q0, q1 = qubits
    cur = {("X", 0): sens.x[q0], ("Z", 0): sens.z[q0],
           ("X", 1): sens.x[q1], ("Z", 1): sens.z[q1]}
    new = {}
    for (p, pos), key in ((("X", 0), ("X", "I")), (("Z", 0), ("Z", "I")),
                          (("X", 1), ("I", "X")), (("Z", 1), ("I", "Z"))):
        _, names = act[key]
        m = 0
        for ppos, nm in enumerate(names):
            b = _BITS_OF_P[nm]
            if b[0]:
                m ^= cur[("X", ppos)]
            if b[1]:
                m ^= cur[("Z", ppos)]
        new[(p, pos)] = m
    sens.x[q0], sens.z[q0] = new[("X", 0)], new[("Z", 0)]
    sens.x[q1], sens.z[q1] = new[("X", 1)], new[("Z", 1)]


def circuit_to_dem(
    circuit: Circuit,
    *,
    allow_gauge_detectors: bool = False,
    approximate_disjoint_errors: bool | float = False,
    flatten_loops: bool = True,
    decompose_errors: bool = False,
    ignore_decomposition_failures: bool = False,
    block_decomposition_from_introducing_remnant_edges: bool = False,
) -> DetectorErrorModel:
    """Derive the detector error model of a noisy Clifford circuit.

    With ``decompose_errors=True``, every error touching 3+ detectors is
    split into graphlike components (<=2 detectors each, separated by ``^``
    suggestion targets) whose symptom sets partition the error's and whose
    observable flips XOR to the error's — stim's decomposition contract.
    At most one component may be a "remnant" edge absent from the model
    (disallowed entirely by the ``block_...`` flag). Failures raise unless
    ``ignore_decomposition_failures`` leaves the error undecomposed.
    """
    flat = circuit.flattened()
    nq = max(circuit.num_qubits, 1)
    num_meas = flat.num_measurements

    # Absolute measurement index -> symptom mask (detectors then observables).
    det_lists: list[list[int]] = []
    obs_lists: dict[int, list[int]] = {}
    meas_seen = 0
    for instr in flat:
        nm = instr.num_measurements
        if instr.name == "DETECTOR":
            det_lists.append([meas_seen + t.value for t in instr.targets_copy()])
        elif instr.name == "OBSERVABLE_INCLUDE":
            idx = int(instr.gate_args_copy()[0])
            obs_lists.setdefault(idx, []).extend(
                meas_seen + t.value for t in instr.targets_copy()
            )
        meas_seen += nm
    num_det = len(det_lists)
    num_obs = max(obs_lists, default=-1) + 1
    meas_mask = [0] * num_meas
    for d, recs in enumerate(det_lists):
        for r in recs:
            meas_mask[r] ^= 1 << d
    for o, recs in obs_lists.items():
        for r in recs:
            meas_mask[r] ^= 1 << (num_det + o)

    # ---------------- backward pass: sensitivity at each noise site ----------
    sens = _Sensitivity(nq)
    # mechanisms collected as (prob, symptom_mask)
    mechanisms: list[tuple[float, int]] = []
    items = list(flat)
    # Pre-compute measurement index offsets per instruction.
    meas_at: list[int] = []
    acc = 0
    for instr in items:
        meas_at.append(acc)
        acc += instr.num_measurements

    approx_ok = bool(approximate_disjoint_errors)
    approx_threshold = (
        approximate_disjoint_errors
        if isinstance(approximate_disjoint_errors, float)
        else 1.0
    )

    def check_disjoint(ps, name):
        live = [p for p in ps if p > 0]
        if len(live) > 1 and not approx_ok:
            raise ValueError(
                f"{name} has disjoint components; pass "
                f"approximate_disjoint_errors=True to decompose them."
            )
        if approx_ok and any(p > approx_threshold for p in live if True):
            if approx_threshold < 1.0 and any(p > approx_threshold for p in live):
                raise ValueError(f"{name} component above approximation threshold")

    for idx in range(len(items) - 1, -1, -1):
        instr = items[idx]
        name = instr.name
        targets = instr.targets_copy()
        args = instr.gate_args_copy()
        m0 = meas_at[idx]

        if name in ("M", "MZ", "MX", "MY", "MR", "MRZ", "MRX", "MRY"):
            basis = name[-1] if name[-1] in "XY" else "Z"
            p = args[0] if args else 0.0
            for k, t in enumerate(targets):
                q = t.value
                mask = meas_mask[m0 + k]
                if p:
                    mechanisms.append((p, mask))
            # Backward through measurement(+reset). The collapse makes the
            # measured Pauli a stabilizer: errors commuting with it die
            # (their future effect is a phase on the eigenstate), errors
            # anticommuting flip the outcome and persist modulo the
            # stabilizer. MR additionally discards everything before.
            for k in reversed(range(len(targets))):
                q = targets[k].value
                mask = meas_mask[m0 + k]
                if name.startswith("MR"):
                    sens.x[q] = 0
                    sens.z[q] = 0
                if basis == "Z":
                    sens.x[q] ^= mask
                    sens.z[q] = 0
                elif basis == "X":
                    sens.z[q] ^= mask
                    sens.x[q] = 0
                else:  # Y basis: X == Z modulo the Y stabilizer
                    m = mask ^ sens.x[q]
                    sens.x[q] = m
                    sens.z[q] = m
            continue
        if name in ("R", "RZ", "RX", "RY"):
            for t in targets:
                sens.x[t.value] = 0
                sens.z[t.value] = 0
            continue
        if name in ("MXX", "MYY", "MZZ"):
            p = args[0] if args else 0.0
            pl = name[1]
            for k in reversed(range(len(targets) // 2)):
                mask = meas_mask[m0 + k]
                if p:
                    mechanisms.append((p, mask))
                for t in (targets[2 * k], targets[2 * k + 1]):
                    q = t.value
                    if pl == "Z":
                        sens.x[q] ^= mask
                    elif pl == "X":
                        sens.z[q] ^= mask
                    else:
                        sens.x[q] ^= mask
                        sens.z[q] ^= mask
            continue
        if name == "MPP":
            p = args[0] if args else 0.0
            products = list(enumerate(_iter_pauli_products(instr)))
            for k, (paulis, _inv) in reversed(products):
                mask = meas_mask[m0 + k]
                if p:
                    mechanisms.append((p, mask))
                for pl, q in paulis:
                    if pl == "Z":
                        sens.x[q] ^= mask
                    elif pl == "X":
                        sens.z[q] ^= mask
                    else:
                        sens.x[q] ^= mask
                        sens.z[q] ^= mask
            continue
        if name == "MPAD":
            continue
        if name == "X_ERROR":
            for t in targets:
                mechanisms.append((args[0], sens.x[t.value]))
            continue
        if name == "Z_ERROR":
            for t in targets:
                mechanisms.append((args[0], sens.z[t.value]))
            continue
        if name == "Y_ERROR":
            for t in targets:
                mechanisms.append((args[0], sens.x[t.value] ^ sens.z[t.value]))
            continue
        if name == "DEPOLARIZE1":
            p = args[0]
            q_ind = 0.5 * (1 - (1 - 4 * p / 3) ** 0.5) if p < 0.75 else 0.5
            for t in targets:
                q = t.value
                for mask in (sens.x[q], sens.z[q], sens.x[q] ^ sens.z[q]):
                    mechanisms.append((q_ind, mask))
            continue
        if name == "DEPOLARIZE2":
            p = args[0]
            q_ind = 0.5 * (1 - (1 - 16 * p / 15) ** 0.125) if p < 15 / 16 else 0.5
            for k in range(len(targets) // 2):
                qa, qb = targets[2 * k].value, targets[2 * k + 1].value
                opts = {"I": 0, "X": sens.x, "Z": sens.z}
                for pa in ("I", "X", "Y", "Z"):
                    for pb in ("I", "X", "Y", "Z"):
                        if pa == pb == "I":
                            continue
                        mask = 0
                        if pa in ("X", "Y"):
                            mask ^= sens.x[qa]
                        if pa in ("Z", "Y"):
                            mask ^= sens.z[qa]
                        if pb in ("X", "Y"):
                            mask ^= sens.x[qb]
                        if pb in ("Z", "Y"):
                            mask ^= sens.z[qb]
                        mechanisms.append((q_ind, mask))
            continue
        if name == "PAULI_CHANNEL_1":
            px, py, pz = args
            check_disjoint([px, py, pz], name)
            for t in targets:
                q = t.value
                for p, mask in (
                    (px, sens.x[q]),
                    (py, sens.x[q] ^ sens.z[q]),
                    (pz, sens.z[q]),
                ):
                    if p:
                        mechanisms.append((p, mask))
            continue
        if name == "PAULI_CHANNEL_2":
            check_disjoint(args, name)
            names2 = [(a, b) for a in "IXYZ" for b in "IXYZ"][1:]
            for k in range(len(targets) // 2):
                qa, qb = targets[2 * k].value, targets[2 * k + 1].value
                for (pa, pb), p in zip(names2, args):
                    if not p:
                        continue
                    mask = 0
                    if pa in ("X", "Y"):
                        mask ^= sens.x[qa]
                    if pa in ("Z", "Y"):
                        mask ^= sens.z[qa]
                    if pb in ("X", "Y"):
                        mask ^= sens.x[qb]
                    if pb in ("Z", "Y"):
                        mask ^= sens.z[qb]
                    mechanisms.append((p, mask))
            continue
        if name in ("HERALDED_ERASE", "HERALDED_PAULI_CHANNEL_1"):
            probs = [args[0] / 4] * 4 if name == "HERALDED_ERASE" else list(args)
            check_disjoint(probs, name)
            for k, t in enumerate(targets):
                q = t.value
                hmask = meas_mask[m0 + k]
                for pl, p in zip("IXYZ", probs):
                    if not p:
                        continue
                    mask = hmask
                    if pl in ("X", "Y"):
                        mask ^= sens.x[q]
                    if pl in ("Z", "Y"):
                        mask ^= sens.z[q]
                    mechanisms.append((p, mask))
            continue
        if name in ("E", "CORRELATED_ERROR", "ELSE_CORRELATED_ERROR"):
            if name == "ELSE_CORRELATED_ERROR" and not approx_ok:
                raise ValueError(
                    "ELSE_CORRELATED_ERROR requires approximate_disjoint_errors"
                )
            mask = 0
            for t in targets:
                if t.pauli_type in ("X", "Y"):
                    mask ^= sens.x[t.value]
                if t.pauli_type in ("Z", "Y"):
                    mask ^= sens.z[t.value]
            mechanisms.append((args[0], mask))
            continue
        if name in ("DETECTOR", "OBSERVABLE_INCLUDE", "TICK", "QUBIT_COORDS",
                    "SHIFT_COORDS", "I", "II", "I_ERROR", "II_ERROR"):
            continue
        if name in ACTIONS_1Q:
            # Reverse within the (fused, multi-target) instruction: this is
            # a backward pass.
            for t in reversed(targets):
                _gate_backward(sens, name, [t.value])
            continue
        if name in ACTIONS_2Q:
            for k in reversed(range(len(targets) // 2)):
                t0, t1 = targets[2 * k], targets[2 * k + 1]
                if t0.is_measurement_record_target or t1.is_measurement_record_target:
                    # Classically-controlled Pauli: the control bit's flip
                    # toggles the Pauli; equivalent symptom dependence is a
                    # measurement-record sensitivity update.
                    _rec_controlled_backward(sens, name, t0, t1, meas_mask, m0)
                else:
                    _gate_backward(sens, name, [t0.value, t1.value])
            continue
        raise ValueError(f"circuit_to_dem cannot handle instruction: {name}")

    # ------------------------------------------------ gauge detectors -------
    gauge_masks = _find_gauge_parities(circuit, det_lists, obs_lists, num_det)
    if gauge_masks and not allow_gauge_detectors:
        bad = [d for mask in gauge_masks for d in _bits(mask) if d < num_det]
        raise ValueError(
            f"Detectors {sorted(set(bad))} are not deterministic under "
            f"noiseless execution (gauge detectors). Pass "
            f"allow_gauge_detectors=True to accept them."
        )

    # ---------------------------------------------------------- assemble ----
    combined: dict[int, float] = {}
    for p, mask in mechanisms:
        if mask == 0 or p == 0:
            continue
        prev = combined.get(mask, 0.0)
        combined[mask] = prev + p - 2 * prev * p
    decompositions: dict[int, list[tuple[int, ...]] | None] = {}
    if decompose_errors:
        decompositions = _decompose_all(
            combined,
            num_det,
            allow_remnant=not block_decomposition_from_introducing_remnant_edges,
            ignore_failures=ignore_decomposition_failures,
        )
    dem = DetectorErrorModel()
    for mask in sorted(combined):
        p = combined[mask]
        parts = decompositions.get(mask)
        if parts is not None:
            targets = []
            for i, part_mask in enumerate(parts):
                if i:
                    targets.append(target_separator())
                targets += [
                    target_relative_detector_id(b) if b < num_det
                    else target_logical_observable_id(b - num_det)
                    for b in _bits(part_mask)
                ]
            dem.append(DemInstruction("error", [p], targets))
            continue
        targets = [
            target_relative_detector_id(b) if b < num_det
            else target_logical_observable_id(b - num_det)
            for b in _bits(mask)
        ]
        dem.append(DemInstruction("error", [p], targets))
    for mask in gauge_masks:
        targets = [
            target_relative_detector_id(b) if b < num_det
            else target_logical_observable_id(b - num_det)
            for b in _bits(mask)
        ]
        dem.append(DemInstruction("error", [0.5], targets))
    # Anchor detector/observable counts (stim records coordinates; we emit
    # nothing for detectors without errors).
    return dem


def _detector_partitions(dets: list[int]):
    """All partitions of ``dets`` into blocks of size 1 or 2, first block
    always containing dets[0] (canonical enumeration order)."""
    if not dets:
        yield []
        return
    a, rest = dets[0], dets[1:]
    for tail in _detector_partitions(rest):
        yield [(a,)] + tail
    for i, b in enumerate(rest):
        for tail in _detector_partitions(rest[:i] + rest[i + 1 :]):
            yield [(a, b)] + tail


def _decompose_all(
    combined: dict[int, float],
    num_det: int,
    *,
    allow_remnant: bool,
    ignore_failures: bool,
):
    """Split 3+-detector errors into graphlike components (stim semantics).

    Returns {mask: [component_masks] | None}; None = leave undecomposed
    (graphlike already, or an ignored failure).
    """
    det_space = (1 << num_det) - 1
    # graphlike lookup: detector-set mask -> available observable masks
    graphlike: dict[int, set[int]] = {}
    for mask in combined:
        det_part = mask & det_space
        if bin(det_part).count("1") <= 2 and det_part:
            graphlike.setdefault(det_part, set()).add(mask & ~det_space)

    out: dict[int, list[tuple[int, ...]] | None] = {}
    for mask in combined:
        det_part = mask & det_space
        obs_part = mask & ~det_space
        dets = _bits(det_part)
        if len(dets) <= 2:
            out[mask] = None
            continue

        def attempt(with_remnant: bool):
            for part in _detector_partitions(dets):
                block_masks = [sum(1 << d for d in blk) for blk in part]
                if not with_remnant:
                    r = _assign_with_remnant(block_masks, None, graphlike, obs_part)
                    if r is not None:
                        return r
                    continue
                for remnant_idx in range(len(block_masks)):
                    if block_masks[remnant_idx] in graphlike:
                        continue  # a known edge never needs remnant status
                    r = _assign_with_remnant(
                        block_masks, remnant_idx, graphlike, obs_part
                    )
                    if r is not None:
                        return r
            return None

        found = attempt(False)
        if found is None and allow_remnant:
            found = attempt(True)
        if found is None:
            if ignore_failures:
                out[mask] = None
                continue
            raise ValueError(
                f"Failed to decompose error into graphlike components: "
                f"detectors {dets}. Pass ignore_decomposition_failures=True "
                f"to keep it undecomposed."
            )
        out[mask] = list(found)
    return out


def _assign_with_remnant(block_masks, remnant_idx, graphlike, obs_part):
    """Pick observable masks for every non-remnant block (DFS over the
    model's graphlike choices); the remnant block, if any, takes whatever
    observable balance remains. ``remnant_idx=None`` requires the chosen
    observables to XOR exactly to ``obs_part``."""
    order = [i for i in range(len(block_masks)) if i != remnant_idx]

    def dfs(k, acc, chosen):
        if k == len(order):
            if remnant_idx is None:
                return chosen if acc == obs_part else None
            remnant = block_masks[remnant_idx] | (obs_part ^ acc)
            full = chosen[:]
            full.insert(remnant_idx, remnant)
            return full
        bm = block_masks[order[k]]
        for ob in sorted(graphlike.get(bm, ())):
            r = dfs(k + 1, acc ^ ob, chosen + [bm | ob])
            if r is not None:
                return r
        return None

    return dfs(0, 0, [])


def _rec_controlled_backward(sens, name, t0, t1, meas_mask, m0):
    # The controlled Pauli commutes with errors for sensitivity purposes
    # except that errors flipping the CONTROL measurement change whether the
    # Pauli fires, which flips any symptom sensitive to that Pauli. This
    # coupling is already captured through the measurement mask when the
    # control measurement's own detectors are used; for DEM purposes the
    # control bit's symptom set gains the target-Pauli sensitivity.
    base = name.upper()
    if base in ("XCZ", "YCZ"):
        t0, t1 = t1, t0
        base = {"XCZ": "CX", "YCZ": "CY"}[base]
    if t1.is_measurement_record_target and base in ("CZ", "ZCZ"):
        t0, t1 = t1, t0
    assert t0.is_measurement_record_target
    pl = {"CX": "X", "CNOT": "X", "ZCX": "X", "CY": "Y", "ZCY": "Y",
          "CZ": "Z", "ZCZ": "Z"}[base]
    q = t1.value
    extra = sens.pauli_mask(pl, q)
    # Errors flipping the recorded control bit (index m0 + t0.value relative)
    # ALSO flip the conditional Pauli: fold into that measurement's mask.
    meas_mask[m0 + t0.value] ^= extra


def _bits(mask: int):
    out = []
    b = 0
    while mask:
        if mask & 1:
            out.append(b)
        mask >>= 1
        b += 1
    return out


def _find_gauge_parities(circuit, det_lists, obs_lists, num_det) -> list[int]:
    """Randomized probe for non-deterministic detector/observable parities.

    Runs the noiseless circuit on the tableau simulator K times with random
    forced outcomes for non-deterministic measurements; parities that vary
    are gauge degrees of freedom. Escape probability ~= 2^-K per gauge.
    """
    from .frame import _run_tableau_forced

    K = 8
    seen = None
    varying = 0
    rng = np.random.default_rng(12345)
    for trial in range(K):
        rec = _run_tableau_forced(circuit, rng if trial else None)
        parities = 0
        for d, recs in enumerate(det_lists):
            v = 0
            for r in recs:
                v ^= int(rec[r])
            parities ^= v << d
        for o, recs in obs_lists.items():
            v = 0
            for r in recs:
                v ^= int(rec[r])
            parities ^= v << (num_det + o)
        if seen is None:
            seen = parities
        varying |= parities ^ seen
    return [1 << b for b in _bits(varying)]
