"""Detector error model with non-deterministic observable support.

Mirrors reference ``tsim/noise/dem.py``: observables are rewritten as
end-of-circuit detectors (rec indices shifted per intervening measurement),
the DEM is derived with gauge detectors allowed, those detectors are mapped
back to ``L{k}`` targets, and pure-observable ``error(0.5)`` gauge
statements are dropped.
"""

from __future__ import annotations

from ..stim_core import Circuit as StimCircuit
from ..stim_core import gate_data, target_rec
from ..stim_core.dem import (
    DemInstruction,
    DetectorErrorModel,
    circuit_to_dem,
    target_logical_observable_id,
)
from ..stim_core.instruction import CircuitRepeatBlock


def get_detector_error_model(
    stim_circuit: StimCircuit,
    *,
    allow_non_deterministic_observables: bool = True,
    decompose_errors: bool = False,
    flatten_loops: bool = False,
    allow_gauge_detectors: bool = False,
    approximate_disjoint_errors: bool | float = False,
    ignore_decomposition_failures: bool = False,
    block_decomposition_from_introducing_remnant_edges: bool = False,
) -> DetectorErrorModel:
    if decompose_errors and allow_non_deterministic_observables:
        raise ValueError(
            "Decomposition of error mechanisms is not supported when allowing "
            "non-deterministic observables."
        )
    if not allow_non_deterministic_observables:
        return circuit_to_dem(
            stim_circuit,
            allow_gauge_detectors=allow_gauge_detectors,
            approximate_disjoint_errors=approximate_disjoint_errors,
            decompose_errors=decompose_errors,
            ignore_decomposition_failures=ignore_decomposition_failures,
            block_decomposition_from_introducing_remnant_edges=(
                block_decomposition_from_introducing_remnant_edges
            ),
        )

    # Rewrite OBSERVABLE_INCLUDEs as end-of-circuit DETECTORs with shifted
    # rec lookbacks, so gauge analysis treats them like detectors.
    obs: dict[int, list[int]] = {}
    new_circuit = StimCircuit()
    for instruction in stim_circuit.flattened():
        assert not isinstance(instruction, CircuitRepeatBlock)
        nm = instruction.num_measurements
        if nm:
            for idx in obs:
                obs[idx] = [t - nm for t in obs[idx]]
        if instruction.name == "OBSERVABLE_INCLUDE":
            idx = int(instruction.gate_args_copy()[0])
            obs.setdefault(idx, []).extend(
                t.value for t in instruction.targets_copy()
            )
        else:
            new_circuit.append(instruction)

    num_detectors = stim_circuit.num_detectors
    mapping: dict[int, int] = {}
    for idx in sorted(obs):
        new_circuit.append(
            "DETECTOR", [target_rec(t) for t in obs[idx]]
        )
        mapping[num_detectors + len(mapping)] = idx

    dem = circuit_to_dem(
        new_circuit,
        allow_gauge_detectors=True,
        approximate_disjoint_errors=approximate_disjoint_errors,
    )

    new_dem = DetectorErrorModel()
    for instruction in dem:
        new_targets = []
        new_type = instruction.type
        for t in instruction.targets_copy():
            if t.is_relative_detector_id() and t.val in mapping:
                new_targets.append(target_logical_observable_id(mapping[t.val]))
                if instruction.type == "detector":
                    new_type = "logical_observable"
            else:
                new_targets.append(t)
        if instruction.args_copy() == [0.5]:
            if all(t.is_logical_observable_id() for t in new_targets):
                continue
        new_dem.append(DemInstruction(new_type, instruction.args_copy(), new_targets))

    if new_dem.num_observables > stim_circuit.num_observables:
        raise ValueError(
            "Failed to compute detector error model: observable count changed."
        )
    # Observables whose only couplings were dropped gauge statements still
    # exist; declare them so the observable count is preserved.
    if new_dem.num_observables < stim_circuit.num_observables:
        for k in range(stim_circuit.num_observables):
            new_dem.append(
                DemInstruction(
                    "logical_observable", [], [target_logical_observable_id(k)]
                )
            )
    return new_dem
