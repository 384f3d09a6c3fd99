"""The port's host compile path against tsim_tpu's, on the CPU (stages b and c).

The same circuit text goes through ``tsim_tpu`` (JAX on the CPU; nothing is
sampled) and through ``tsim_tpu_torch``:

* ``prepare_graph`` (``sample_detectors`` False and True) gives equal
  ``channel_probs``, ``error_transform``, ``num_outputs`` and
  ``num_detectors``, and the host ``ChannelSampler`` an equal signature
  matrix and channels;
* ``compile_program`` gives an equal program through ``program_io.flatten``:
  every leaf's dtype, shape and value, and the header (rung sizes,
  ``output_indices``, ``f_selection``), with no tolerance. Here: d3
  distillation at p = 0.02, the same in joint mode (state probabilities),
  two seeded random circuits; d5 and 1-check cultivation have files of their
  own (``test_torch_compile_d5.py``, ``test_torch_compile_cultivation.py``).

The planner's plan depends on which ZX engine runs it (the native one or
its Python fallback, whose RNG stream differs). Both packages take the same
one on the same host, so they agree either way; a case that holds the port
to a committed program or to a term-count pin needs the native engine, and
is skipped only where tsim_tpu's own ``requires_native_planner`` skips.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import tsim_tpu
import tsim_tpu_torch
from tests.helpers.gen import gen_circuit_text
from tsim_tpu.compile.pipeline import compile_program as jax_compile_program
from tsim_tpu.core.graph_prep import prepare_graph as jax_prepare_graph
from tsim_tpu.noise.channels import ChannelSampler as JaxChannelSampler
from tsim_tpu_torch import program_io
from tsim_tpu_torch.compile.pipeline import compile_program
from tsim_tpu_torch.core.graph_prep import prepare_graph
from tsim_tpu_torch.models import distillation_d3
from tsim_tpu_torch.noise.channels import ChannelSampler
from tsim_tpu_torch.sampler import compile_circuit

# Seeded random circuits over the non-Clifford gates and the noise channels.
RANDOM_WEIGHTS = {
    "T": 2, "H": 2, "CNOT": 2, "S": 1, "R_Z(0.33)": 1, "U3(0.34, 0.21, 0.46)": 1,
    "R_PAULI2": 1, "X_ERROR(0.4)": 1, "DEPOLARIZE1(0.4)": 1, "DEPOLARIZE2(0.5)": 1,
    "PAULI_CHANNEL_1(0.3, 0.2, 0.1)": 1,
}
RANDOM_SEEDS = (5, 11)


def random_circuit_text(seed: int) -> str:
    """A seeded random circuit of 4 qubits with a CCZ, measured, with two
    detectors and an observable, so that both compile modes have outputs."""
    text = gen_circuit_text(4, 16, include_measurements=False, gate_weights=RANDOM_WEIGHTS, seed=seed)
    return text + (
        "\nCCZ 0 1 2\nH 3\nM 0 1 2 3\nDETECTOR rec[-1] rec[-2]\nDETECTOR rec[-3]\n"
        "OBSERVABLE_INCLUDE(0) rec[-4]"
    )


def assert_same_leaves(got, want) -> None:
    """Equal through ``program_io.flatten``: header, keys, and every leaf's
    dtype, shape and value."""
    assert program_io.leaf_differences(got, want) == []


def reference_compile(text: str, *, sample_detectors: bool, mode: str):
    """tsim_tpu's compile of ``text`` (prepare_graph, compile_program, its host
    channel sampler) as an ``ExportedProgram``."""
    prepared = jax_prepare_graph(tsim_tpu.Circuit(text), sample_detectors=sample_detectors)
    program = jax_compile_program(prepared, mode=mode)
    channels = JaxChannelSampler(prepared.channel_probs, prepared.error_transform, seed=0)
    return program_io.from_reference(program, channels, prepared.num_detectors)


def port_compile(text: str, *, sample_detectors: bool, mode: str):
    exported, stats = compile_circuit(
        tsim_tpu_torch.Circuit(text), sample_detectors=sample_detectors, mode=mode
    )
    assert stats["planner"] in ("native", "python")
    return exported


D3_TEXT = str(distillation_d3(p=0.02))
PREP_CASES = {
    "d3": D3_TEXT,
    **{f"random{s}": random_circuit_text(s) for s in RANDOM_SEEDS},
    "ccz": "H 0 1 2\nCCZ 0 1 2\nX_ERROR(0.1) 0\nH 0 1 2\nM 0 1 2\nDETECTOR rec[-1]",
}


@pytest.mark.parametrize("sample_detectors", [False, True])
@pytest.mark.parametrize("name", sorted(PREP_CASES))
def test_prepare_graph_equals_tsim_tpu(name, sample_detectors):
    text = PREP_CASES[name]
    got = prepare_graph(tsim_tpu_torch.Circuit(text), sample_detectors=sample_detectors)
    want = jax_prepare_graph(tsim_tpu.Circuit(text), sample_detectors=sample_detectors)
    assert (got.num_outputs, got.num_detectors) == (want.num_outputs, want.num_detectors)
    assert got.error_transform.dtype == want.error_transform.dtype
    np.testing.assert_array_equal(got.error_transform, want.error_transform)
    assert len(got.channel_probs) == len(want.channel_probs)
    for g, w in zip(got.channel_probs, want.channel_probs):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got.graph.num_vertices() == want.graph.num_vertices()

    cs = ChannelSampler(got.channel_probs, got.error_transform, seed=0)
    ref = JaxChannelSampler(want.channel_probs, want.error_transform, seed=0)
    np.testing.assert_array_equal(cs.signature_matrix, ref.signature_matrix)
    assert len(cs.channels) == len(ref.channels)
    for g, w in zip(cs.channels, ref.channels):
        assert g.unique_col_ids == w.unique_col_ids
        np.testing.assert_array_equal(g.probs, w.probs)
    np.testing.assert_array_equal(cs.sample(256), ref.sample(256))


COMPILE_CASES = [
    pytest.param(D3_TEXT, True, "sequential", id="d3"),
    pytest.param(D3_TEXT, False, "joint", id="d3_joint"),
    *[pytest.param(random_circuit_text(s), True, "sequential", id=f"random{s}") for s in RANDOM_SEEDS],
    *[
        pytest.param(random_circuit_text(s), False, "sequential", id=f"random{s}_measurements")
        for s in RANDOM_SEEDS
    ],
]


@pytest.mark.parametrize("text, sample_detectors, mode", COMPILE_CASES)
def test_compile_program_equals_tsim_tpu(text, sample_detectors, mode):
    """Both packages plan with the same engine (the native one where g++
    builds it, else the Python one), so the programs are equal either way."""
    got = port_compile(text, sample_detectors=sample_detectors, mode=mode)
    want = reference_compile(text, sample_detectors=sample_detectors, mode=mode)
    assert got.program.components
    assert_same_leaves(got, want)


def test_leaf_differences_names_each_difference():
    """The gate of every comparison above fails on a changed dtype, value,
    missing leaf or header entry."""
    exported = port_compile(D3_TEXT, sample_detectors=True, mode="sequential")
    assert program_io.leaf_differences(exported, exported) == []
    rung = exported.program.components[0].compiled_scalar_graphs[3]
    phases = rung.node_phases
    for changed, name in [
        (phases.phases.astype(np.int32), "c0.r3.node_phases.phases"),
        (phases.phases ^ (phases.phases == 0), "c0.r3.node_phases.phases"),
    ]:
        node = dataclasses.replace(phases, phases=changed)
        rungs = list(exported.program.components[0].compiled_scalar_graphs)
        rungs[3] = dataclasses.replace(rung, node_phases=node)
        comp = dataclasses.replace(exported.program.components[0], compiled_scalar_graphs=tuple(rungs))
        other = dataclasses.replace(
            exported, program=dataclasses.replace(exported.program, components=(comp,))
        )
        assert program_io.leaf_differences(exported, other) == [name]
    fewer = dataclasses.replace(exported, num_detectors=exported.num_detectors - 1)
    assert program_io.leaf_differences(exported, fewer) == ["header.num_detectors"]
    no_const = dataclasses.replace(exported, program=dataclasses.replace(exported.program, direct_const_mask=None))
    assert program_io.leaf_differences(exported, no_const) == ["program.direct_const_mask"]


def test_compile_program_writes_program_io_dataclasses():
    exported = port_compile(D3_TEXT, sample_detectors=True, mode="sequential")
    program = exported.program
    assert isinstance(program, program_io.CompiledProgram)
    comp = program.components[0]
    assert isinstance(comp, program_io.CompiledComponent)
    assert all(isinstance(i, int) for i in comp.output_indices + comp.f_selection)
    rung = comp.compiled_scalar_graphs[0]
    assert isinstance(rung, program_io.CompiledScalarGraphs)
    assert isinstance(rung.node_phases, program_io.NodePhases)
    assert isinstance(rung.prefactor, program_io.ScalarPrefactor)


def test_clifford_program_has_no_component():
    """A Clifford circuit compiles to direct outputs only, and its sampler
    draws them on the host (``test_torch_direct_sampling.py`` holds the
    bits to tsim_tpu's)."""
    c = tsim_tpu_torch.models.rotated_surface_code_memory_z(3, 2, after_clifford_depolarization=0.02)
    program = compile_program(prepare_graph(c, sample_detectors=True), mode="sequential")
    assert not program.components and len(program.direct_f_indices) == c.num_detectors + 1
    sampler = c.compile_detector_sampler(seed=0, device="cpu")
    assert sampler.direct_route in ("host_channels", "native_frame")
    assert sampler.sample(8, append_observables=True).shape == (8, c.num_detectors + 1)
