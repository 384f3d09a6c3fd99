"""Measurements -> detection events conversion (stim m2d equivalent)."""

from __future__ import annotations

import numpy as np

from .circuit import Circuit
from .frame import reference_sample


class CompiledMeasurementsToDetectionEventsConverter:
    """Converts raw measurement samples into detector/observable flips.

    Detection event = (measured parity) XOR (noiseless reference parity).
    """

    def __init__(self, circuit: Circuit, *, skip_reference_sample: bool = False):
        self.circuit = circuit
        flat = circuit.flattened()
        num_meas = flat.num_measurements
        if skip_reference_sample:
            self.reference = np.zeros(num_meas, dtype=bool)
        else:
            self.reference = reference_sample(circuit)
        self.det_lists: list[list[int]] = []
        self.obs_lists: dict[int, list[int]] = {}
        seen = 0
        for instr in flat:
            if instr.name == "DETECTOR":
                self.det_lists.append([seen + t.value for t in instr.targets_copy()])
            elif instr.name == "OBSERVABLE_INCLUDE":
                idx = int(instr.gate_args_copy()[0])
                self.obs_lists.setdefault(idx, []).extend(
                    seen + t.value for t in instr.targets_copy()
                )
            seen += instr.num_measurements
        self.num_measurements = num_meas
        self.num_obs = circuit.num_observables

    def convert(
        self,
        *,
        measurements: np.ndarray,
        separate_observables: bool = False,
        append_observables: bool = False,
    ):
        m = np.asarray(measurements, dtype=bool)
        if m.ndim != 2 or m.shape[1] != self.num_measurements:
            raise ValueError(
                f"measurements must have shape (shots, {self.num_measurements})"
            )
        shots = m.shape[0]
        dets = np.zeros((shots, len(self.det_lists)), dtype=bool)
        for d, recs in enumerate(self.det_lists):
            v = np.zeros(shots, dtype=bool)
            ref = False
            for r in recs:
                v ^= m[:, r]
                ref ^= bool(self.reference[r])
            dets[:, d] = v ^ ref
        obs = np.zeros((shots, self.num_obs), dtype=bool)
        for o, recs in self.obs_lists.items():
            v = np.zeros(shots, dtype=bool)
            ref = False
            for r in recs:
                v ^= m[:, r]
                ref ^= bool(self.reference[r])
            obs[:, o] = v ^ ref
        if separate_observables:
            return dets, obs
        if append_observables:
            return np.concatenate([dets, obs], axis=1)
        return dets
