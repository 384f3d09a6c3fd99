"""Compiled samplers and state probabilities on a torch device.

Counterpart of ``tsim_tpu/sampler.py``. A sampler is built from a
:class:`~tsim_tpu_torch.circuit.Circuit`, which is compiled on the host
first (:func:`compile_circuit`: ``prepare_graph``, ``compile_program`` and
the host ``ChannelSampler``, through the AOT cache), or from a program that
comes as data (``program_io.ExportedProgram``). Each batch draws noise on the device, copies the direct
outputs and runs every component's plugged-circuit ladder (one evaluation
per rung, f32 or exact, chain-rule Bernoulli draws). The batches form a
pipeline: batch k's (shots, outputs) bits are copied to pinned host memory
on a stream of their own while the device works on batch k + 1
(:class:`_RowsToHost`). On a card each shard's batch step (the noise draw
and the ladders) is captured once as a CUDA graph and replayed for every
later batch of its size (:class:`_StepGraph`, ``tsim_tpu``'s one jit per
batch step). With a postselection mask, shots whose direct
detectors fire are discarded on the device before any evaluation.
A fully-direct program (no components, as every Clifford circuit compiles
to) needs no evaluation: it is drawn on the host, as in ``tsim_tpu``, by the
C++ Pauli-frame engine (``stim_core/native_frame.py``) on a CUDA device, or
by the seeded host ``ChannelSampler`` (``direct_route`` names which).
:class:`CompiledStateProbs` evaluates joint-mode programs exactly. Every
sampler saves and loads a checkpoint that continues its sample stream.
With a mesh (``mesh=``, ``parallel/shard.py``) the shots of each batch are
split over the mesh's devices, each shard with its own generator, tables
and copy stream; one host thread enqueues every shard's work.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
import warnings
from dataclasses import dataclass, fields
from math import ceil

import numpy as np
import torch
from torch import nn

from .compile.sample_eval import (
    F32_OPS_PER_S,
    bytes_per_row,
    check_evaluation,
    ensure_self_test,
    evaluate_abs_sample,
    least_seconds_per_row,
    norm_deviation_tolerance,
    rung_tables,
)
from .compile.exact_tables import ExactTables
from .compile.sample_tables import SampleTables
from .compile import aot_cache
from .compile.pipeline import compile_program
from .core.graph_prep import prepare_graph
from .kernels import launches
from .noise.channels import Channel, ChannelSampler
from .noise.device_channels import DeviceChannelSampler
from .ops.gf2 import static_take_columns
from .parallel.shard import (
    ShotMesh,
    indexed_device,
    make_shot_mesh,
    replicate,
    shard_generators,
    shard_sizes,
)
from .program_io import (
    ExportedProgram,
    NoiseModel,
    flatten,
    noise_from_reference,
    read_npz,
    unflatten,
    write_npz,
)
from .utils.profiling import note, span
from .zx import native_simplify


def compile_circuit(
    circuit, *, sample_detectors: bool, mode: str, strategy: str = "cat5"
) -> tuple[ExportedProgram, dict]:
    """Compile ``circuit`` on the host, as ``tsim_tpu/sampler.py:615-690`` does:
    (the program with its noise model, ``compile_stats``).

    The AOT cache is looked up first; on a miss ``prepare_graph`` and
    ``compile_program`` run and their result is stored. The host
    ``ChannelSampler`` simplifies the channels into the
    ``program_io.NoiseModel`` the device draw samples (its own draws are
    not used, so its seed is fixed). The stats
    hold each stage's seconds and the ZX engine that planned the
    decompositions: "native" (the C++ engine), "python" (its fallback,
    where ``g++`` is missing or ``TSIM_TPU_NATIVE_ZX=0``) or "mixed" (the
    engine was loaded, but some of its calls handed their graph back to the
    Python engine). A mixed compile is not stored in the AOT cache, whose
    key names the engine, so a cache hit is never mixed.
    """
    with span("tsim.compile"):
        aot_key = aot_cache.cache_key(
            str(circuit._stim_circ), sample_detectors=sample_detectors, mode=mode, strategy=strategy
        )
        cached = aot_cache.fetch(aot_key)
        note(cache_hit=cached is not None)
        t0 = time.perf_counter()
        if cached is not None:
            program = cached.program
            channel_probs = cached.channel_probs
            error_transform = cached.error_transform
            num_detectors = cached.num_detectors
            t1 = t2 = t0
            mixed = False
        else:
            fallbacks = native_simplify.fallbacks
            prepared = prepare_graph(circuit, sample_detectors=sample_detectors)
            t1 = time.perf_counter()
            program = compile_program(prepared, mode=mode, strategy=strategy)
            t2 = time.perf_counter()
            channel_probs = prepared.channel_probs
            error_transform = prepared.error_transform
            num_detectors = prepared.num_detectors
            mixed = native_simplify.fallbacks > fallbacks
            if not mixed:
                aot_cache.store(
                    aot_key,
                    aot_cache.CompiledEntry(
                        program=program,
                        channel_probs=channel_probs,
                        error_transform=error_transform,
                        num_detectors=num_detectors,
                    ),
                )
        channel_sampler = ChannelSampler(
            channel_probs=channel_probs, error_transform=error_transform, seed=0
        )
        stats = {
            "prepare_s": round(t1 - t0, 3),
            "decompose_s": round(t2 - t1, 3),
            "channels_s": round(time.perf_counter() - t2, 3),
            "planner": "python" if native_simplify._load() is None else "mixed" if mixed else "native",
        }
        exported = ExportedProgram(
            program=program, noise=noise_from_reference(channel_sampler), num_detectors=num_detectors
        )
        return exported, stats


def _long(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int64).ravel())


class ComponentTables(nn.Module):
    """One component: its f-column selection, output indices and the
    evaluator tables of each rung (``rung_tables``)."""

    def __init__(self, component, evaluation: str = "f32", per_term: bool | None = None):
        super().__init__()
        self.register_buffer("f_selection", _long(component.f_selection))
        self.register_buffer("output_indices", _long(component.output_indices))
        self.rungs = nn.ModuleList(
            rung_tables(c, evaluation, per_term) for c in component.compiled_scalar_graphs
        )


class ProgramTables(nn.Module):
    """A compiled program's device data; ``.to(device)`` moves all of it once.

    ``evaluation`` is "f32" or "exact" and ``per_term`` chooses the f32
    kernels (see ``compile/sample_eval.py::rung_tables``).
    """

    def __init__(self, program, evaluation: str = "f32", per_term: bool | None = None):
        super().__init__()
        self.num_outputs = int(program.num_outputs)
        n_direct = len(np.asarray(program.direct_f_indices))
        self.register_buffer("direct_f_indices", _long(program.direct_f_indices))
        self.register_buffer(
            "direct_output_order", _long(np.asarray(program.output_order)[:n_direct])
        )
        self.register_buffer(
            "direct_flips", torch.as_tensor(np.asarray(program.direct_flips, np.uint8).ravel())
        )
        mask = program.direct_const_mask
        mask = np.zeros(n_direct, bool) if mask is None else np.asarray(mask, bool)
        self.has_const = bool(mask.any())
        self.register_buffer("direct_const_mask", torch.as_tensor(mask))
        self.has_reindex = program.output_reindex is not None
        reindex = program.output_reindex if self.has_reindex else ()
        self.register_buffer("output_reindex", _long(reindex))
        self.components = nn.ModuleList(
            ComponentTables(c, evaluation, per_term) for c in program.components
        )

    def node_fold_counts(self) -> dict:
        """Each exact rung's graphs, live node-phase terms and the terms of
        phase 0 or 4 that ``exact_wide``'s fold takes out of its per-shot
        stage (``compile/node_fold.py``), in component then rung order."""
        exact = [r for comp in self.components for r in comp.rungs
                 if isinstance(r, ExactTables) and r.node_terms is not None]
        return dict(
            exact_rung_graphs=[r.num_graphs for r in exact],
            live_node_terms=[r.node_terms[0] for r in exact],
            folded_node_terms=[r.node_terms[1] for r in exact],
        )

    def direct_outputs(self, f_params: torch.Tensor) -> torch.Tensor:
        """(B, num_outputs) uint8: the direct outputs in their output columns, 0 elsewhere."""
        out = torch.zeros(
            (f_params.shape[0], self.num_outputs), dtype=torch.uint8, device=f_params.device
        )
        if len(self.direct_f_indices):
            out[:, self.direct_output_order] = self.direct_bits(f_params)
        return out

    def direct_bits(self, f_params: torch.Tensor) -> torch.Tensor:
        """(B, n_direct) uint8 direct outputs of noise configurations ``f_params``."""
        batch = f_params.shape[0]
        if f_params.shape[1] == 0:
            gathered = torch.zeros(
                (batch, len(self.direct_f_indices)), dtype=torch.uint8, device=f_params.device
            )
        else:
            gathered = static_take_columns(f_params, self.direct_f_indices)
        direct = gathered ^ self.direct_flips
        if self.has_const:
            direct = torch.where(self.direct_const_mask, self.direct_flips, direct)
        return direct


def _sample_component(comp: ComponentTables, f_params, generator, uniforms=None):
    """Autoregressively sample one component's outputs.

    Rung k's magnitude is the joint probability of the first k+1 output
    bits, so each new bit is Bernoulli(p_one / mass) against the running
    prefix probability ``mass``. A probe row (shot 0 with the new bit
    forced to 0) rides along in every rung's evaluation to monitor
    normalization. ``uniforms`` (an iterator of (shots,) float32 tensors,
    one per rung) replaces the generator's draws.
    Returns (bits (shots, n_rungs - 1) uint8, max norm deviation).
    """
    shots = f_params.shape[0]
    device = f_params.device
    ladder = comp.rungs
    noise_bits = static_take_columns(f_params, comp.f_selection)
    mass = evaluate_abs_sample(ladder[0], noise_bits)
    drawn = torch.zeros((shots, len(ladder) - 1), dtype=torch.uint8, device=device)
    worst = torch.zeros((), dtype=torch.float32, device=device)
    pad_one = torch.ones((shots, 1), dtype=torch.uint8, device=device)
    pad_zero = torch.zeros((1, 1), dtype=torch.uint8, device=device)

    for k, rung in enumerate(ladder[1:]):
        stacked = torch.cat(
            [
                torch.cat([noise_bits, drawn[:, :k], pad_one], dim=1),
                torch.cat([noise_bits[:1], drawn[:1, :k], pad_zero], dim=1),
            ],
            dim=0,
        )
        magnitudes = evaluate_abs_sample(rung, stacked)
        p_one, probe = magnitudes[:shots], magnitudes[-1]
        worst = torch.maximum(worst, torch.abs((probe + p_one[0]) / mass[0] - 1.0))
        if uniforms is None:
            u = torch.rand((shots,), generator=generator, device=device, dtype=torch.float32)
        else:
            u = next(uniforms).to(device)
        # 0/0 gives NaN, and u < NaN is False: such a shot draws bit 0.
        bit = u < torch.clamp(p_one / mass, 0.0, 1.0)
        drawn[:, k] = bit.to(torch.uint8)
        mass = torch.where(bit, p_one, mass - p_one)

    return drawn, worst


# Bytes a row of a rung's draw, beside its rows: the next uniforms, the
# ratio p_one / mass and its clamp (float32), and the compare (bool).
_DRAW_BYTES = 13


def _component_bytes_per_row(comp: ComponentTables, device: torch.device) -> int:
    """Bytes a row that :func:`_sample_component` holds at its peak on
    ``device``, its drawn bits included: its noise columns, the drawn bits,
    the pad, and the running mass, last magnitudes, uniforms and bits (13
    bytes) throughout; the first rung's evaluation; then for each later
    rung its (B + 1, P) rows beside the largest of their concatenation (the
    previous rung's rows and the inner copy), the rung's evaluation
    (``compile/sample_eval.py::bytes_per_row``) and the draw."""
    rungs = comp.rungs
    held = len(comp.f_selection) + len(rungs) - 1 + 1 + _DRAW_BYTES
    peak, prev = bytes_per_row(rungs[0], device), 0
    for rung in rungs[1:]:
        width = rung.n_params
        peak = max(peak, width + max(prev + width, bytes_per_row(rung, device), _DRAW_BYTES))
        prev = width
    return held + peak


def _ladder_bytes_per_row(tables: ProgramTables, num_f: int, device: torch.device) -> int:
    """Bytes a row that :func:`sample_program_with_deviation` holds at its
    peak on ``device``, counted from the shapes it allocates: the (B, num_f)
    noise rows throughout, beside each component's ladder with the outputs
    drawn before it (at most num_outputs), or beside the outputs, their
    concatenation and its reindexed copy."""
    n_out = tables.num_outputs
    peak = 3 * n_out
    for comp in tables.components:
        peak = max(peak, n_out + _component_bytes_per_row(comp, device))
    return num_f + peak


def sample_program_with_deviation(tables: ProgramTables, f_params, generator, uniforms=None):
    """Sample every output: ((B, num_outputs) uint8 in output order, (1,) max deviation).

    ``uniforms`` optionally gives the per-rung draw uniforms, in component
    then rung order, in place of ``generator``.
    """
    device = f_params.device
    batch = f_params.shape[0]
    max_dev = torch.zeros((1,), dtype=torch.float32, device=device)
    if tables.num_outputs == 0:
        return torch.zeros((batch, 0), dtype=torch.uint8, device=device), max_dev
    draws = None if uniforms is None else iter(uniforms)
    results = []
    if len(tables.direct_f_indices):
        results.append(tables.direct_bits(f_params))
    for comp in tables.components:
        bits, dev = _sample_component(comp, f_params, generator, draws)
        max_dev = torch.maximum(max_dev, dev.reshape(1))
        results.append(bits)
    combined = torch.cat(results, dim=1)
    if tables.has_reindex:
        combined = static_take_columns(combined, tables.output_reindex)
    return combined, max_dev


def _direct_detector_mask(program, num_detectors: int) -> np.ndarray:
    """(num_detectors,) bool, True where a detector is a direct output (the
    ``det_mask`` of tsim_tpu's ``_plan_direct_scatter``)."""
    n = len(np.asarray(program.direct_f_indices))
    mask = np.zeros(program.num_outputs, dtype=np.bool_)
    mask[np.asarray(program.output_order, np.int64)[:n]] = True
    return mask[:num_detectors]


class _NoiseModelChannels(ChannelSampler):
    """The host ``ChannelSampler`` of a noise model's simplified channels.

    A ``ChannelSampler`` that ``tsim_tpu`` builds from a circuit samples
    only its simplified channels and signature matrix, which
    ``program_io.NoiseModel`` holds as they are, so this one draws the same
    bits at the same seed. A noise model whose channels do not fit its
    signature matrix raises ValueError.
    """

    def __init__(self, noise: NoiseModel, seed: int):
        signatures = np.asarray(noise.signature_matrix, np.uint8)
        if signatures.ndim != 2 or any(
            len(ch.probs) != 2 ** len(ch.unique_col_ids)
            or any(not 0 <= i < signatures.shape[0] for i in ch.unique_col_ids)
            for ch in noise.channels
        ):
            raise ValueError(
                "a program without components samples on the host from its noise model, "
                "whose channels do not fit its signature matrix here: compile such a "
                "program from a Circuit"
            )
        self.channels = [
            Channel(probs=np.asarray(ch.probs, np.float64), unique_col_ids=tuple(ch.unique_col_ids))
            for ch in noise.channels
        ]
        self.signature_matrix = signatures
        self._rng = np.random.default_rng(seed)
        self._sparse_data = self._precompute_sparse(self.channels, self.signature_matrix)


class _RowsToHost:
    """Moves batches of (rows, n) 0/1 uint8 bits on the device into rows of
    the host bool array ``result``, behind the device's later work.

    On a CUDA device :meth:`push` records an event behind the batch on its
    device's current stream, has a copy stream wait on it, copies the bits
    (viewed as bool) into one of two pinned staging buffers there (the second
    is made only for a second batch), and returns once the
    batch pushed before it is in ``result``: so the caller enqueues batch k +
    1's work before the host waits on batch k's copy, and the copy and the
    host's move overlap the device's work. A staging buffer is reused two
    pushes later, after its copy has been waited on; the batch's tensor is
    held until then. A fault of the copy raises from that wait. The host's
    move is a torch copy, which spreads a large one over the CPU's threads
    (the first touch of a fresh result's pages is most of its cost). On the
    CPU the rows are moved at once. :meth:`close` moves what is left.
    """

    def __init__(self, result: np.ndarray, device: torch.device, rows: int):
        self.result = result
        self.cuda = device.type == "cuda"
        self.pending = collections.deque()  # (copy done, staging buffer, first row, rows, bits)
        if self.cuda:
            self.stream = torch.cuda.Stream(device)
            self.shape = (rows, result.shape[1])
            self.staging = []  # pinned, made by the first two pushes
            self.pushed = 0

    def push(self, bits: torch.Tensor, start: int) -> None:
        """Write ``bits`` into ``result[start : start + len(bits)]``."""
        n = bits.shape[0]
        if not self.cuda:
            with span("tsim.to_host.move", rows=n, bytes=n * self.result.shape[1]):
                self._rows(start, n).copy_(bits.view(torch.bool))
            return
        if self.pushed < 2:
            self.staging.append(torch.empty(self.shape, dtype=torch.bool, pin_memory=True))
        staging = self.staging[self.pushed % 2]
        self.pushed += 1
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(bits.device))
        self.stream.wait_event(ready)
        with torch.cuda.stream(self.stream):
            staging[:n].copy_(bits.view(torch.bool), non_blocking=True)
        done = torch.cuda.Event()
        done.record(self.stream)
        self.pending.append((done, staging, start, n, bits))
        while len(self.pending) > 1:
            self._move()

    def _rows(self, start: int, n: int) -> torch.Tensor:
        return torch.from_numpy(self.result[start : start + n])

    def _move(self) -> None:
        done, staging, start, n, _bits = self.pending.popleft()
        with span("tsim.to_host.wait"):
            done.synchronize()
        with span("tsim.to_host.move", rows=n, bytes=n * self.result.shape[1]):
            self._rows(start, n).copy_(staging[:n])

    def close(self) -> None:
        while self.pending:
            self._move()


def _kept_rows(keep: torch.Tensor, count: int) -> torch.Tensor:
    """The indices of ``keep``'s True entries, ascending, given their
    ``count``, without a host read: each kept row scatters its index to its
    rank; the discarded ones all land on a spare slot past the end."""
    rank = torch.cumsum(keep, dim=0) - 1
    slot = torch.where(keep, rank, torch.full_like(rank, count))
    rows = torch.empty(count + 1, dtype=torch.int64, device=keep.device)
    rows.scatter_(0, slot, torch.arange(keep.shape[0], device=keep.device))
    return rows[:count]


def _check_norm_deviation(max_dev: float, evaluation: str = "f32") -> None:
    val = float(max_dev)
    if np.isclose(val, 1):
        raise ValueError(
            "A vanishing marginal probability distribution was encountered "
            "(normalization 0). This is likely the result of an underflow error."
        )
    if val > norm_deviation_tolerance(evaluation):
        warnings.warn(
            "A marginal probability was not normalized correctly "
            f"(normalization deviated from 1 by {val:.1e}). "
            "This is likely a floating point precision issue.",
            stacklevel=2,
        )


def _resolve_device(device) -> torch.device:
    """``device``, or "cuda" for None, with its index ("cuda" names the
    current card); a CUDA device must exist (no fallback)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the sampler runs on the card; pass "
            'device="cpu" to run on the CPU with the plain versions of the kernels'
        )
    return indexed_device(device)


# "auto" gives a card at least this many rows of a batch of d3 distillation
# (f32), and of another program as many rows as hold the same device work
# (auto_cards): below it the one host thread's enqueue of every shard's
# launches costs more than the cards save. d3 on four H100s, a batch split
# over k cards against the same batch on one (dev/torch_shard_scaling.py
# --threshold, PERF.md section 6): 2^18 rows a card 0.90x (k = 2) and 0.93x
# (k = 4), 2^19 1.33x and 1.40x.
AUTO_MIN_ROWS_PER_CARD = 1 << 19
# d3 distillation's device work a row (least_seconds_per_row over its f32
# ladder: 10,140 float32 operations), the work AUTO_MIN_ROWS_PER_CARD holds.
AUTO_REFERENCE_SECONDS_PER_ROW = 10_140 / F32_OPS_PER_S
# No program gets fewer rows a card than this: the host's enqueue of a
# shard's batch costs the same whatever its work, and the least time a row
# overstates how much more real device time a heavy program takes than d3
# (2-check cultivation exact: 44x d3's least time, 3x its time a row on one
# card). On four H100s 2-check exact and grown cultivation f32 split into
# 2^16 rows a card ran at 0.49x and 0.72x one card, at 2^18 rows a card at
# 1.23x and 2.2x (dev/torch_shard_scaling.py --auto, PERF.md section 6).
AUTO_FLOOR_ROWS_PER_CARD = 1 << 18
# The default batch gives a card at most this many rows, the batch from
# which a card's rate stops rising (one H100, dev/torch_shard_scaling.py
# --sweep, PERF.md section 6); beyond it a larger batch only delays the
# first copy and holds more memory.
DEFAULT_ROWS_PER_CARD = 1 << 20


def _auto_mesh() -> ShotMesh | None:
    """The cards "auto" may shard over: every visible CUDA device where there
    are two or more, else None."""
    if torch.cuda.is_available() and torch.cuda.device_count() > 1:
        return make_shot_mesh()
    return None


def auto_cards(rows: int, cards: int, card_rows: int, seconds_per_row: float) -> int:
    """How many of ``cards`` an "auto" mesh shards a batch of ``rows`` rows
    over, for a program of ``seconds_per_row`` device work a row (the least
    time of its ladders' evaluations, ``_CompiledSamplerBase._seconds_per_row``):
    as many as each get the work of AUTO_MIN_ROWS_PER_CARD rows of d3
    distillation, that is AUTO_MIN_ROWS_PER_CARD * AUTO_REFERENCE_SECONDS_PER_ROW
    / seconds_per_row rows but at least AUTO_FLOOR_ROWS_PER_CARD (2^19 for
    d3, 2^18 for a program of twice its work or more), and more where fewer
    would give a card over ``card_rows`` rows (its memory budget,
    ``_CompiledSamplerBase._card_rows``); at least one, at most ``cards``."""
    share = AUTO_MIN_ROWS_PER_CARD * AUTO_REFERENCE_SECONDS_PER_ROW / max(seconds_per_row, 1e-30)
    share = max(AUTO_FLOOR_ROWS_PER_CARD, round(share))
    return max(1, min(cards, max(ceil(rows / card_rows), rows // share)))


def _resolve_mesh(mesh, device) -> tuple[ShotMesh | None, torch.device]:
    """(the sampling mesh or None, the sampler's device) of the ``mesh`` and
    ``device`` arguments.

    None samples unsharded. "auto" with ``device`` None and two or more
    cards visible resolves to the mesh of every card (:func:`_auto_mesh`),
    whose first card is the sampler's; each batch then takes only the first
    :func:`auto_cards` of them, as many as each get a share of the batch's
    device work: the work of AUTO_MIN_ROWS_PER_CARD rows of d3 distillation
    (calibrated on four H100s, where d3's 2^19 rows a card first beat one
    card), so that a program of more work a row takes more cards at the same
    batch, down to AUTO_FLOOR_ROWS_PER_CARD rows a card (more also where a
    card's memory budget would otherwise be exceeded), and a batch that one card takes samples unsharded on the
    first card (``_CompiledSamplerBase._plan_batches``). So the stream "auto"
    draws depends on the batch size: a batch of B rows over k cards draws
    shard i's generator for i < k, one on one card the unsharded generator.
    "auto" samples unsharded on the CPU, on one card and with an explicit
    ``device``. A :class:`ShotMesh` of one entry samples
    unsharded on its device; a larger one is used as given, every batch split
    over all of it. A mesh's first device is the sampler's device: an
    explicit ``device`` that is another one raises. Sharded and unsharded
    samplers draw different (each seeded and reproducible) streams.
    """
    if mesh is None:
        return None, _resolve_device(device)
    if isinstance(mesh, str):
        if mesh != "auto":
            raise ValueError(f'mesh must be None, "auto" or a ShotMesh, got {mesh!r}')
        auto = _auto_mesh() if device is None else None
        if auto is not None:
            return auto, auto.devices[0]
        return None, _resolve_device(device)
    if not isinstance(mesh, ShotMesh):
        raise TypeError(f'mesh must be None, "auto" or a ShotMesh, got {type(mesh).__name__}')
    first = mesh.devices[0]
    if device is not None and indexed_device(device) != first:
        raise ValueError(
            f"device {device} is not the mesh's first device {first}: a sharded sampler "
            "lives on its mesh's first device"
        )
    return (mesh if mesh.size > 1 else None), first


def on_device(device: torch.device):
    """A context that makes ``device`` the current card (nothing for the CPU),
    so that every tensor a shard's work allocates lands on its device."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


@dataclass
class _Shard:
    """One mesh entry of a sampler: its device, generator, tables and noise
    sampler (the last two shared by the entries of one device), and its
    captured batch step: ``graph`` (a :class:`_StepGraph` or None) and
    ``warm_rows``, the rows of the last batch that ran eagerly to warm a
    size up (:func:`_step_action`). An unsharded sampler has one, with its
    own generator."""

    device: torch.device
    generator: torch.Generator
    tables: ProgramTables
    channels: DeviceChannelSampler
    graph: "_StepGraph | None" = None
    warm_rows: int = 0


def _graphs_on(device: torch.device) -> bool:
    """Whether a shard on ``device`` captures its batch step: on a card."""
    return device.type == "cuda"


def _step_action(warm_rows: int, graph_rows: int | None, rows: int) -> str:
    """What a shard does with a full batch of ``rows`` rows, given the rows
    it last warmed up and those of its graph (None without one): "replay"
    the graph of that size; "capture" one (and replay it) where the size
    was warmed up by an eager batch before, dropping the graph of another
    size (a shard keeps one); else "eager", which warms the size up. So a
    size's first batch runs eagerly, its second is captured, and a step that
    is never repeated is never captured."""
    if graph_rows == rows:
        return "replay"
    if warm_rows == rows:
        return "capture"
    return "eager"


class _StepGraph:
    """One shard's batch step of ``rows`` rows, its noise draw and
    :func:`sample_program_with_deviation`, captured once as a CUDA graph
    and replayed for every later batch of that size: the counterpart of the
    executable ``tsim_tpu`` compiles once per program, noise sampler, batch
    size and mesh (``tsim_tpu/sampler.py::_device_run_fn``, whose one jit
    lets XLA fuse the step). A replay enqueues the whole step as one launch.

    Capture records on a stream of the shard's device (a graph cannot be
    captured on the default stream) and runs nothing; a replay runs on the
    device's current stream. Where the trouble lies:

    * RNG: the step draws from the shard's generator, which is registered
      with the graph (``CUDAGraph.register_generator_state``), so that a
      replay reads the generator's offset when it is replayed and advances
      it by the step's draws, exactly as the eager step does: the bits of a
      replay equal the eager step's on the same generator state, and a
      checkpoint saved after replays resumes the stream.
    * Work before capture: the K4 self-test compares on the host, so it runs
      first (:func:`ensure_self_test`; the eager warm-up batch has already
      run it once, and built and loaded the kernels' library, unless the
      self-test was forgotten since). The kernels' launch paths may set a
      kernel's shared-memory attribute, which a capture allows.
    * Launch counts: capture makes no launch, so what the wrappers counted
      while capturing is taken off again, and each replay counts it
      (``kernels/launches.py``).
    * Static outputs: every replay rewrites ``out`` and ``dev``. The caller
      takes ``dev`` into a running maximum at once and pushes a fresh
      tensor of ``out``'s bits (its fold, else a copy) to the host, which
      :class:`_RowsToHost` holds until its copy is done; so batch k's copy
      to the host overlaps batch k + 1's replay and nothing rewrites it.
    * A capture that fails raises RuntimeError naming the shard's device
      and the rows; nothing falls back to the eager step.

    The caller's ``tsim.capture`` span holds the host's time to make one
    (the graph's first replay, which uploads it, follows). It is paid once
    a shard and size: the step's enqueue, the new segments of the graph's
    private memory pool (``cudaMalloc``, whose host time varies most) and
    the instantiation in ``capture_end``.
    """

    def __init__(self, sampler: "_CompiledSamplerBase", shard: _Shard, rows: int):
        self.rows = rows
        device = shard.device
        if any(isinstance(rung, SampleTables) for comp in shard.tables.components for rung in comp.rungs):
            ensure_self_test(device)
        self.graph = torch.cuda.CUDAGraph()
        before = launches.snapshot()
        try:
            if not hasattr(self.graph, "register_generator_state"):
                raise RuntimeError(
                    f"torch {torch.__version__} has no CUDAGraph.register_generator_state: a graph "
                    "cannot draw from the shard's generator"
                )
            self.graph.register_generator_state(shard.generator)
            # capture_begin/end rather than torch.cuda.graph, whose entry
            # synchronises the card and empties the allocator's cache, which
            # a capture does not need.
            with torch.cuda.stream(torch.cuda.Stream(device)):
                self.graph.capture_begin()
                try:
                    self.out, self.dev = sampler._sample_batch(rows, shard=shard)
                except BaseException:
                    with contextlib.suppress(Exception):
                        self.graph.capture_end()
                    raise
                self.graph.capture_end()
        except Exception as exc:
            raise RuntimeError(
                f"capturing the batch step (noise draw and ladders) of {rows} rows on {device} "
                f"failed: {exc}"
            ) from exc
        finally:
            self._launches = launches.since(before)
            launches.restore(before)

    def replay(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Run the captured step on the current stream: (the static (rows,
        num_outputs) uint8 bits, the static (1,) norm deviation)."""
        self.graph.replay()
        launches.add(self._launches)
        return self.out, self.dev


def _worst(deviations) -> float:
    """The host's max of (device, (1,) deviation) pairs: one read a device."""
    merged = {}
    for device, dev in deviations:
        merged[device] = dev if device not in merged else torch.maximum(merged[device], dev)
    with span("tsim.deviation.read"):
        return max(float(d[0]) for d in merged.values())


class _PostselectedShard:
    """One shard's share of a postselected call: ``shots`` shots whose rows
    start at ``first`` in the host array ``result``, drawn on the shard's
    device in chunks of ``chunk`` shots.

    Each chunk draws its noise, its direct bits and the prefilter over the
    masked direct detectors (``post``, after the detector reference fold)
    on the device (:meth:`draw`, which returns the survivor count still on
    the device). Its rows start as the direct detector columns, false
    elsewhere; once the host has read the count (:meth:`take`) its
    survivors join a pool, which is evaluated in batches of ``chunk`` (the
    last one shorter), and each evaluated survivor's row is scattered into
    its chunk's rows. Discarded shots never reach an evaluator. A chunk
    whose survivors are all evaluated goes to the host through
    :class:`_RowsToHost`; chunks wait on the device until then.
    """

    def __init__(self, shard: _Shard, result, first: int, shots: int, chunk: int, nd: int,
                 post, fold_kept, fold_dropped):
        device = shard.device

        def on(a):
            return torch.as_tensor(np.asarray(a, np.uint8), device=device)

        self.shard, self.first, self.shots, self.chunk, self.nd = shard, first, shots, chunk, nd
        self.n_out = result.shape[1]
        self.post = on(post).bool()
        self.masked_ref = on(fold_kept[:nd]).bool() & self.post
        self.fold_kept, self.fold_dropped = on(fold_kept), on(fold_dropped[:nd])
        self.to_host = _RowsToHost(result, device, min(chunk, shots))
        self.worst = torch.zeros((1,), dtype=torch.float32, device=device)
        self.chunks = collections.deque()  # [first row, rows (want, n_out) uint8, survivors not yet evaluated]
        self.pool = collections.deque()  # [noise rows, their rows in their chunk, the chunk], oldest first
        self.pooled = self.taken = 0
        self.drawn = None

    @property
    def done(self) -> bool:
        return self.taken == self.shots

    def draw(self) -> torch.Tensor:
        """Enqueue the next chunk's noise, direct bits and prefilter; its
        survivor count, on the device."""
        want = min(self.chunk, self.shots - self.taken)
        shard, nd = self.shard, self.nd
        with span("tsim.postsel.draw", rows=want), on_device(shard.device):
            f_params = shard.channels.sample(shard.generator, want)
            direct = shard.tables.direct_outputs(f_params)[:, :nd]
            keep = ~((direct.bool() & self.post) ^ self.masked_ref).any(dim=1)
            rows = torch.zeros((want, self.n_out), dtype=torch.uint8, device=shard.device)
            rows[:, :nd] = direct ^ self.fold_dropped
            self.drawn = (f_params, keep, rows, want)
            return keep.sum()

    def take(self, survivors: int) -> None:
        """Pool the drawn chunk's ``survivors``, evaluate every full batch of
        the pool (and the rest after the last chunk), push finished chunks."""
        f_params, keep, rows, want = self.drawn
        with on_device(self.shard.device):
            chunk = [self.first + self.taken, rows, survivors]
            self.chunks.append(chunk)
            if survivors:
                kept = _kept_rows(keep, survivors)
                self.pool.append([f_params.index_select(0, kept), kept, chunk])
            self.pooled += survivors
            self.taken += want
            while self.pooled >= self.chunk or (self.done and self.pooled):
                self._evaluate(min(self.chunk, self.pooled))
            while self.chunks and self.chunks[0][2] == 0:
                start, rows, _ = self.chunks.popleft()
                self.to_host.push(rows, start)

    def _evaluate(self, n: int) -> None:
        with span("tsim.postsel.evaluate", rows=n):
            parts, got = [], 0
            while got < n:
                f, rows, chunk = self.pool[0]
                k = min(n - got, f.shape[0])
                parts.append((f[:k], rows[:k], chunk))
                if k == f.shape[0]:
                    self.pool.popleft()
                else:
                    self.pool[0] = [f[k:], rows[k:], chunk]
                got += k
            out, dev = sample_program_with_deviation(
                self.shard.tables, torch.cat([f for f, _, _ in parts]), self.shard.generator
            )
            out = out ^ self.fold_kept
            self.worst = torch.maximum(self.worst, dev)
            at = 0
            for f, rows, chunk in parts:
                chunk[1].index_copy_(0, rows, out[at : at + f.shape[0]])
                chunk[2] -= f.shape[0]
                at += f.shape[0]
            self.pooled -= n

    def close(self) -> None:
        self.to_host.close()


class _CompiledSamplerBase:
    """Shared sampling machinery over a compiled program.

    ``source`` is a :class:`~tsim_tpu_torch.circuit.Circuit`, compiled here
    with ``strategy`` (``compile_stats`` then holds the compile's stages and
    planner), or an :class:`~tsim_tpu_torch.program_io.ExportedProgram`
    (``compile_stats`` None; with no circuit, a fully-direct program takes
    the host channel route). ``evaluation`` selects how rungs are evaluated: "f32" (the default;
    rungs that fail ``sample_eligible`` are still exact) or "exact" (every
    rung; the norm monitor's band narrows from 3e-3 to 1e-5). ``per_term``
    True runs every f32 rung through the per-term kernels (the slower
    oracle of the packed ones), False through the packed ones where its rows
    fit; None follows ``TSIM_TPU_SAMPLE_TPACK`` as tsim_tpu does. ``mesh``
    ("auto", None or a :class:`~tsim_tpu_torch.parallel.shard.ShotMesh`,
    read by :func:`_resolve_mesh`) splits the shots over devices.
    """

    _sample_detectors = False
    _mode = "sequential"

    def __init__(
        self, source, *, seed: int | None = None, device=None, evaluation: str = "f32",
        per_term: bool | None = None, strategy: str = "cat5", mesh="auto",
    ):
        self.evaluation = check_evaluation(evaluation)
        self._mesh, self.device = _resolve_mesh(mesh, device)
        # What save() records: "auto" where the automatic rule chose the
        # mesh, the device list of an explicit mesh, else None.
        self._mesh_spec = (
            "auto" if mesh == "auto" and device is None
            else None if self._mesh is None else [str(d) for d in self._mesh.devices]
        )
        if seed is None:
            seed = int(np.random.default_rng().integers(0, 2**30))
        if isinstance(source, ExportedProgram):
            exported, self.compile_stats, self.circuit = source, None, None
        else:
            exported, self.compile_stats = compile_circuit(
                source, sample_detectors=self._sample_detectors, mode=self._mode, strategy=strategy
            )
            self.circuit = source
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        self._per_term = per_term
        self._program = exported.program
        self._noise = exported.noise
        self._num_detectors = int(exported.num_detectors)
        prog = exported.program
        self._direct_f_indices = np.asarray(prog.direct_f_indices)
        self._direct_flips = np.asarray(prog.direct_flips, dtype=np.bool_)
        self._direct_const_mask = (
            np.asarray(prog.direct_const_mask, dtype=np.bool_)
            if prog.direct_const_mask is not None
            else np.zeros(len(self._direct_f_indices), dtype=np.bool_)
        )
        self._direct_reindex = (
            np.asarray(prog.output_reindex) if prog.output_reindex is not None else None
        )
        n_direct = len(self._direct_f_indices)
        # Column j of the host f-sample is direct output j, with no flip,
        # constant or permutation in between (tsim_tpu's scatter fastpath).
        self._direct_fastpath = (
            n_direct > 0
            and np.array_equal(self._direct_f_indices, np.arange(n_direct))
            and self._direct_reindex is None
            and not (self._direct_flips.any() or self._direct_const_mask.any())
        )
        self._direct_detector_mask = _direct_detector_mask(prog, self._num_detectors)
        # A fully-direct program is drawn on the host (tsim_tpu's seeds): by
        # the native frame engine, built at its first use, or by this
        # ChannelSampler.
        self._channel_sampler = None
        self._native_frame = None
        if not prog.components:
            self._channel_sampler = _NoiseModelChannels(
                exported.noise, int(np.random.default_rng(seed).integers(0, 2**30))
            )
            self._native_frame_seed = int(np.random.default_rng(seed + 1).integers(0, 2**30))
        with span("tsim.tables", evaluation=evaluation):
            self._tables = ProgramTables(prog, evaluation, per_term).to(self.device)
            note(**self._tables.node_fold_counts())
        self._device_channels = DeviceChannelSampler(exported.noise, self.device)
        devices = (self.device,) if self._mesh is None else self._mesh.distinct
        self._replicas = replicate(self._tables, devices)
        self._solo = _Shard(self.device, self._generator, self._tables, self._device_channels)
        if self._mesh is None:
            self._shards = [self._solo]
        else:
            channels = {
                d: self._device_channels if d == self.device else DeviceChannelSampler(exported.noise, d)
                for d in devices
            }
            self._shards = [
                _Shard(d, g, self._replicas[d], channels[d])
                for d, g in zip(self._mesh.devices, shard_generators(seed, self._mesh))
            ]
        self._reference_seed = seed
        self._reference: np.ndarray | None = None
        # Largest normalization deviation of the last sample() call (the
        # monitor warns above norm_deviation_tolerance()).
        self.last_norm_deviation: float | None = None
        # The batch steps of the last plain batch loop, by kind
        # (_sample_batches).
        self.last_batch_steps: dict[str, int] | None = None

    def _shards_for(self, rows: int, card_rows: int | None = None) -> list[_Shard]:
        """The shards a batch of ``rows`` rows is split over: every shard of
        the mesh, except under "auto", which takes the first
        :func:`auto_cards` (``card_rows``, a card's memory budget, read if
        not given) and, where that is one, the unsharded shard (see
        :func:`_resolve_mesh`)."""
        if self._mesh is None or self._mesh_spec != "auto":
            return self._shards
        k = auto_cards(rows, self._mesh.size, card_rows or self._card_rows(), self._seconds_per_row())
        return self._shards[:k] if k > 1 else [self._solo]

    def __repr__(self) -> str:
        """tsim_tpu's dashboard: direct outputs, graphs, error channel bits,
        the largest component's outputs, parameters, the four families' term
        counts (A node phases, B half-pi phases, C pi products, D phase pairs)
        and the tables' bytes."""
        n_direct = len(self._program.direct_f_indices)
        c_graphs, c_params = [], []
        a = b = c = d = 0
        num_outputs = []
        total_bytes = 0
        for comp in self._program.components:
            for circ in comp.compiled_scalar_graphs:
                num_outputs.append(len(comp.output_indices))
                c_graphs.append(circ.num_graphs)
                c_params.append(circ.n_params)
                a += circ.node_phases.phases.size
                b += circ.halfpi_phases.coeffs.size
                c += circ.pi_products.psi_const.size
                d += circ.phase_pairs.alpha.size + circ.phase_pairs.beta.size
                for part in (circ.node_phases, circ.halfpi_phases, circ.pi_products,
                             circ.phase_pairs, circ.prefactor):
                    leaves = (getattr(part, f.name) for f in fields(part))
                    total_bytes += sum(v.nbytes for v in leaves if isinstance(v, np.ndarray))
        error_bits = sum(len(ch.unique_col_ids) for ch in self._noise.channels)

        def fmt(n):
            if n < 1024:
                return f"{n} B"
            if n < 1024**2:
                return f"{n / 1024:.1f} kB"
            return f"{n / 1024**2:.1f} MB"

        route = self.direct_route
        return (
            f"{type(self).__name__}({n_direct} direct, {int(np.sum(c_graphs))} graphs, "
            f"{error_bits} error channel bits, "
            f"{max(num_outputs) if num_outputs else 0} outputs for largest cc, "
            f"≤ {max(c_params) if c_params else 0} parameters, {a} A terms, "
            f"{b} B terms, {c} C terms, {d} D terms, {fmt(total_bytes)}"
            f"{'' if route is None else f', {route} route'})"
        )

    # ---------------------------------------------------------------- direct
    @property
    def direct_route(self) -> str | None:
        """How a fully-direct program is sampled, as tsim_tpu routes it:
        "native_frame" (the C++ Pauli-frame engine, for a Clifford circuit
        on a CUDA device or with ``TSIM_TPU_NATIVE_DIRECT=1``) or
        "host_channels" (the host ``ChannelSampler``: any other fully-direct
        program). None for a program with components."""
        if self._program.components:
            return None
        native = self.device.type == "cuda" or os.environ.get("TSIM_TPU_NATIVE_DIRECT") == "1"
        if native and self.circuit is not None and self.circuit.is_clifford:
            return "native_frame"
        return "host_channels"

    def _native_frame_sampler(self):
        """The native Pauli-frame engine of the fully-direct Clifford
        circuit, built at first use (None for any other circuit). A failure
        to build or load ``frame_kernels`` raises ``NativeBuildError``."""
        if self._native_frame is None:
            if self.circuit is None or not self.circuit.is_clifford:
                return None
            from .stim_core.native_frame import NativeFrameSampler

            # The engine gives detector flips (observables it reports
            # absolutely): detector samplers fold the noiseless detector
            # values into its op stream (det_bias), so their rows come out
            # absolute, as the ZX path gives them.
            det_bias = self._reference_sample()[: self._num_detectors] if self._sample_detectors else None
            self._native_frame = NativeFrameSampler(
                self.circuit.stim_circuit, seed=self._native_frame_seed, det_bias=det_bias
            )
        return self._native_frame

    def _sample_direct(self, shots: int) -> np.ndarray:
        """(shots, num_outputs) bool of a fully-direct program from the host
        ``ChannelSampler``."""
        f_params = self._channel_sampler.sample(shots)
        if self._direct_fastpath:
            return f_params[:, : len(self._direct_f_indices)].view(np.bool_)
        if f_params.shape[1] == 0:
            result = np.broadcast_to(self._direct_flips, (shots, len(self._direct_f_indices))).copy()
        else:
            result = f_params[:, self._direct_f_indices] ^ self._direct_flips
        if self._direct_const_mask.any():
            result[:, self._direct_const_mask] = self._direct_flips[self._direct_const_mask]
        if self._direct_reindex is not None:
            result = result[:, self._direct_reindex]
        return result.view(np.bool_)

    def _sample_fully_direct(self, shots: int) -> np.ndarray:
        """(shots, num_outputs) bool of a fully-direct program, on the route
        :attr:`direct_route` names. The frame engine's result may be a
        buffer it reuses once the caller drops it."""
        if self.direct_route == "native_frame":
            native = self._native_frame_sampler()
            if self._sample_detectors:
                return native.sample_det_obs_joined(shots)
            return native.sample(shots, include_measurements=True)[0]
        return self._sample_direct(shots)

    # ------------------------------------------------------- checkpointing
    def _options(self) -> dict:
        """The constructor's keywords besides ``seed`` and ``device``."""
        return {"evaluation": self.evaluation, "per_term": self._per_term}

    def save(self, path) -> None:
        """Checkpoint the sampler as one ``.npz`` (no pickle): the program,
        noise model and detector count as ``program_io`` writes them, then
        the class, seed, device type, mesh and options, the circuit's text,
        the generator's state, each shard generator's state and, for a
        fully-direct program, the host ``ChannelSampler``'s. :meth:`load`
        rebuilds the tables and continues the same sample stream; the
        native frame engine restarts from its seed, as tsim_tpu's does after
        a load. The mesh is recorded as its device list where it was given;
        where "auto" chose it, as "auto" with the cards it resolved to
        (none on one card), which :meth:`load` takes again, so that every
        batch of the reloaded sampler takes the shards the original's would
        and the stream goes on as it would have."""
        exported = ExportedProgram(program=self._program, noise=self._noise, num_detectors=self._num_detectors)
        arrays, header = flatten(exported)
        header["checkpoint"] = {
            "class": type(self).__name__, "seed": self._reference_seed,
            "device": self.device.type, "mesh": self._mesh_spec, "options": self._options(),
            "mesh_devices": None if self._mesh is None else [str(d) for d in self._mesh.devices],
            "circuit": None if self.circuit is None else str(self.circuit),
            "channel_state": None if self._channel_sampler is None
            else self._channel_sampler._rng.bit_generator.state,
        }
        arrays["checkpoint.generator_state"] = self._generator.get_state().numpy()
        if self._mesh is not None:
            for i, shard in enumerate(self._shards):
                arrays[f"checkpoint.shard_generator_state.{i}"] = shard.generator.get_state().numpy()
        write_npz(path, arrays, header)

    @classmethod
    def load(cls, path):
        """Restore a sampler written by :meth:`save` onto the device type it
        was saved from (a CUDA checkpoint raises without a card) or onto its
        mesh (a saved device that is missing raises, naming it; an "auto"
        mesh is rebuilt on the cards it resolved to, and keeps choosing its
        shards by batch size); a checkpoint of another class raises TypeError."""
        arrays, header = read_npz(path)
        saved = header.pop("checkpoint", None)
        if saved is None:
            raise ValueError(f"{path}: a program file, not a sampler checkpoint")
        if saved["class"] != cls.__name__:
            raise TypeError(f"checkpoint holds {saved['class']}, not {cls.__name__}")
        state = torch.from_numpy(arrays.pop("checkpoint.generator_state"))
        shard_states = [arrays.pop(f"checkpoint.shard_generator_state.{i}") for i in range(
            sum(k.startswith("checkpoint.shard_generator_state.") for k in arrays))]
        spec = saved.get("mesh")
        # A checkpoint from before "auto" recorded its cards resolves it again.
        mesh = saved.get("mesh_devices", "auto") if spec == "auto" else spec
        device = saved["device"] if mesh is None else None
        if isinstance(mesh, list):
            mesh = ShotMesh(mesh)
        obj = cls(unflatten(arrays, header), seed=saved["seed"], device=device, mesh=mesh, **saved["options"])
        if spec == "auto":
            obj._mesh_spec = "auto"
        obj._generator.set_state(state)
        if obj._mesh is not None and len(shard_states) == obj._mesh.size:
            for shard, shard_state in zip(obj._shards, shard_states):
                shard.generator.set_state(torch.from_numpy(shard_state))
        if saved.get("circuit") is not None:
            from .circuit import Circuit

            obj.circuit = Circuit(saved["circuit"])
        if saved.get("channel_state") is not None:
            obj._channel_sampler._rng.bit_generator.state = saved["channel_state"]
        return obj

    def _seconds_per_row(self) -> float:
        """The device work of a row: the least time of its ladders'
        evaluations on a card (``least_seconds_per_row`` summed over every
        rung), which :func:`auto_cards` shares out."""
        return sum(least_seconds_per_row(rung) for comp in self._tables.components for rung in comp.rungs)

    def _peak_bytes_per_sample(self, device: torch.device, postselected: bool = False) -> int:
        """Bytes a row of one shard's batch at its peak on ``device`` (the
        plain versions on a CPU, the kernels on a card), counted from the
        shapes the batch loop allocates: two batches' outputs (one waiting
        for its copy to the host, the other's or its folded copy) beside
        the larger of the noise draw
        (``DeviceChannelSampler.peak_bytes_per_shot`` on ``device``) and
        the ladders (:func:`_ladder_bytes_per_row`). On a
        card, a shard's captured step (:class:`_StepGraph`) holds the larger
        of the noise draw and the ladders, allocated once, and a replay's
        bits are pushed as a fresh copy (or their fold), as an eager batch's
        are; the eager warm-up batch's outputs still wait for their copy
        while the step is captured.

        A postselected chunk (:class:`_PostselectedShard`) holds its noise
        rows, keep mask and rows; the pool's survivors and their row indices
        (two chunks' at most, so at least half of the shots must survive for
        the count to hold); the rows of two chunks that wait for survivors
        and of one that waits for its copy; and beside them the larger of
        the next chunk's noise draw with its direct outputs, and the ladder
        with its folded outputs."""
        noise = self._device_channels.peak_bytes_per_shot(device)
        num_f, n_out = self._device_channels.num_f, self._program.num_outputs
        ladder = _ladder_bytes_per_row(self._tables, num_f, device)
        if not postselected:
            return 2 * n_out + max(noise, ladder)
        held = (num_f + 1 + n_out) + 2 * (num_f + 8) + 3 * n_out
        return held + max(noise + 2 * n_out, ladder + n_out)

    def _card_rows(self, postselected: bool = False) -> int:
        """The memory budget of a shard's batch in rows: half of the free
        memory of each device over its shards' peak bytes a row
        (:meth:`_peak_bytes_per_sample`), the least over the devices."""
        shards_on = collections.Counter(s.device for s in self._shards)
        rows, reads = [], 0
        for device, k in shards_on.items():
            if device.type == "cuda":
                available, _total = torch.cuda.mem_get_info(device)
                reads += 1
            else:
                available = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
            rows.append(int(available * 0.5) // self._peak_bytes_per_sample(device, postselected) // k)
        note(mem_reads=reads)
        return max(1, min(rows))

    def _estimate_batch_size(self, postselected: bool = False) -> int:
        """The default batch: a shard's memory budget, at most
        DEFAULT_ROWS_PER_CARD, times the shards."""
        return min(self._card_rows(postselected), DEFAULT_ROWS_PER_CARD) * len(self._shards)

    @staticmethod
    def _validate_shot_args(shots: int, batch_size: int | None) -> None:
        if shots < 0:
            raise ValueError(f"shots must be non-negative, got {shots}")
        if batch_size is not None and batch_size < 1:
            raise ValueError(f"batch_size must be at least 1, got {batch_size}")

    def _plan_batches(self, shots: int, batch_size: int | None,
                      postselected: bool = False) -> tuple[int, list[_Shard]]:
        """(the batch size, the shards each batch is split over), chosen from
        one reading of the memory budget (of a postselected call's chunks
        where ``postselected``), so that no card of an "auto" mesh gets more
        rows than its budget: ``batch_size`` or by default the budget, at
        most DEFAULT_ROWS_PER_CARD, times the shards, evened out over the
        batches; the shards as :meth:`_shards_for` picks them for a batch of
        that size. Its ``tsim.plan`` span counts the batch's rows, its
        shards and the reads of a card's free memory (``mem_reads``)."""
        with span("tsim.plan", mem_reads=0):
            auto = self._mesh is not None and self._mesh_spec == "auto"
            card_rows = self._card_rows(postselected) if batch_size is None or auto else None
            if batch_size is None:
                per_card = min(card_rows, DEFAULT_ROWS_PER_CARD)
                num_batches = max(1, ceil(shots / (per_card * len(self._shards))))
                batch_size = ceil(shots / num_batches)
            shards = self._shards_for(min(batch_size, shots), card_rows)
            note(batch_rows=batch_size, shards=len(shards))
        return batch_size, shards

    def _reference_sample(self) -> np.ndarray:
        """The outputs of the all-zero noise row, (num_outputs,) bool.

        Counterpart of tsim_tpu's ``_compute_reference_sample``: the ladder
        on f = 0, computed once per sampler and cached. Its draws come from
        a generator of their own, so the sample stream does not depend on
        whether a reference was asked for; outputs that are random without
        noise take one draw, as in tsim_tpu. A fully-direct program's is its
        direct outputs at f = 0, by the same path.
        """
        if self._reference is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(self._reference_seed)
            f_ref = torch.zeros((1, self._device_channels.num_f), dtype=torch.uint8, device=self.device)
            out, dev = sample_program_with_deviation(self._tables, f_ref, generator)
            _check_norm_deviation(float(dev.reshape(-1)[0]), self.evaluation)
            self._reference = out[0].cpu().numpy().astype(np.bool_)
        return self._reference

    def _sample_batches(self, shots: int, batch_size: int | None = None, fold=None) -> np.ndarray:
        """(shots, num_outputs) bool samples; ``fold``, a (num_outputs,) bool
        row, is XORed into every row on the device (the reference folds).
        Each batch is split over the shards (one when unsharded) as
        ``tensor_split`` cuts it, each shard's rows contiguous in the result.
        A fully-direct program is drawn on the host in one go
        (``batch_size`` unused) and folded there.

        On a card a shard's full batches (its share of the first batch's
        rows) go through its captured step (:meth:`_batch_step`): the first
        batch of a size runs eagerly, the next is captured, and the later
        ones replay it, in this call and in later ones. A shorter last batch
        and every batch on the CPU run eagerly. ``last_batch_steps`` counts
        the call's "eager" batches and its "capture"s and "replay"s (a
        captured batch is replayed too).
        Each batch's norm deviation goes into a running maximum on its
        device, read once a device at the end."""
        self._validate_shot_args(shots, batch_size)
        num_outputs = self._program.num_outputs
        if shots == 0:
            return np.empty((0, num_outputs), dtype=np.bool_)
        if not self._program.components:
            samples = self._sample_fully_direct(shots)
            if fold is not None:
                samples ^= np.asarray(fold, np.bool_)
            return samples
        batch_size, shards = self._plan_batches(shots, batch_size)

        result = np.empty((shots, num_outputs), dtype=np.bool_)
        full = shard_sizes(min(batch_size, shots), len(shards))
        to_host = [_RowsToHost(result, s.device, n) for s, n in zip(shards, full)]
        folds = {s.device: None if fold is None else torch.as_tensor(np.asarray(fold, np.uint8), device=s.device)
                 for s in shards}
        worst = {s.device: torch.zeros((1,), dtype=torch.float32, device=s.device) for s in shards}
        steps = collections.Counter(eager=0, capture=0, replay=0)
        for start in range(0, shots, batch_size):
            sizes = shard_sizes(min(batch_size, shots - start), len(shards))
            # Every shard's noise and ladder are enqueued before any copy.
            batches = [
                self._batch_step(s, n, steps, graphed=n == f, busy=shards) if n else None
                for s, n, f in zip(shards, sizes, full)
            ]
            at = start
            for i, (shard, sink, n) in enumerate(zip(shards, to_host, sizes)):
                if n:
                    # Taken out of the list, so that a folded batch's own bits
                    # are freed before the next batch's step.
                    out, dev, replayed = batches[i]
                    batches[i] = None
                    fold_d = folds[shard.device]
                    with on_device(shard.device):
                        torch.maximum(worst[shard.device], dev, out=worst[shard.device])
                        # A replay's bits are the graph's static output, which
                        # the next replay rewrites: push a fresh tensor.
                        if fold_d is not None:
                            out = out ^ fold_d
                        elif replayed:
                            out = out.clone()
                        sink.push(out, at)
                at += n
        for sink in to_host:
            sink.close()
        self.last_batch_steps = dict(steps)
        self.last_norm_deviation = _worst(worst.items())
        _check_norm_deviation(self.last_norm_deviation, self.evaluation)
        return result

    def _batch_step(self, shard: _Shard, rows: int, steps: collections.Counter,
                    graphed: bool, busy: list[_Shard]) -> tuple[torch.Tensor, torch.Tensor, bool]:
        """Enqueue one shard's batch of ``rows`` rows: (bits, (1,) deviation,
        whether they are a replay's static outputs). A ``graphed`` batch on a
        card goes through the shard's captured step as :func:`_step_action`
        decides; any other batch is :meth:`_sample_batch`. Counts the step
        in ``steps``, and in its ``tsim.step`` span with its rows, device and
        action; a capture's ``tsim.capture`` span holds the making of the
        :class:`_StepGraph`. A capture first drops the graphs of the shards
        on the same device that the call (``busy``, its shards) does not
        use: under mesh="auto" the unsharded shard and the mesh's first
        share card 0, and a device keeps only the graphs of one call's
        shards, which the memory model counts."""
        graphed = graphed and _graphs_on(shard.device)
        action = (_step_action(shard.warm_rows, None if shard.graph is None else shard.graph.rows, rows)
                  if graphed else "eager")
        with span("tsim.step", rows=rows, device=shard.device, action=action):
            if action == "eager":
                if graphed:
                    shard.warm_rows = rows
                steps["eager"] += 1
                return (*self._sample_batch(rows, shard=shard), False)
            with on_device(shard.device):
                if action == "capture":
                    # The graph of another size goes before the new one is made.
                    for other in self._every_shard():
                        if other.device == shard.device and (other is shard or all(other is not b for b in busy)):
                            other.graph = None
                    with span("tsim.capture", rows=rows):
                        shard.graph = _StepGraph(self, shard, rows)
                    steps["capture"] += 1
                steps["replay"] += 1
                out, dev = shard.graph.replay()
            return out, dev, True

    def _drop_graphs(self) -> None:
        """Forget every shard's captured step and warmed-up size, so the
        next batch of any size runs eagerly and frees the graphs' memory."""
        for shard in self._every_shard():
            shard.graph, shard.warm_rows = None, 0

    def _every_shard(self) -> list[_Shard]:
        """The unsharded shard and the mesh's shards, each once."""
        return list({id(s): s for s in (self._solo, *self._shards)}.values())

    def _sample_batch(self, shots: int, stage=None, shard: _Shard | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """Enqueue one batch's noise draw and ladder on ``shard`` (the first
        one by default), eagerly: ((shots, num_outputs) uint8 bits, (1,) max
        norm deviation), both on its device. The step a shard's graph
        captures. ``stage(name)``, if given, is called as each ends, with
        "noise" or "ladder": the hook of a serialised split of an eager step
        (``dev/torch_profile_d3.py``); the batch loop passes none."""
        shard = shard or self._shards_for(shots)[0]
        mark = stage or (lambda name: None)
        with on_device(shard.device):
            f_params = shard.channels.sample(shard.generator, shots)
            mark("noise")
            out, dev = sample_program_with_deviation(shard.tables, f_params, shard.generator)
            mark("ladder")
        return out, dev

    def _sample_batches_with_postselection(
        self,
        shots: int,
        batch_size: int | None,
        *,
        postselection_mask: np.ndarray,
        fold_detector_reference: bool = False,
        fold_observable_reference: bool = False,
    ) -> np.ndarray:
        """Postselected sampling: (shots, num_outputs) bool samples.

        Counterpart of tsim_tpu's ``_sample_batches_with_postselection``,
        kept on the device: each shard takes a contiguous share of the shots
        (all of them when unsharded) and runs :class:`_PostselectedShard`'s
        loop of chunks, prefilter, survivor pool and scatter on its device,
        in chunks of ``batch_size`` split over the shards. Each round
        enqueues every shard's next chunk before the first survivor count is
        read, so no device waits on another's host read. The reference folds
        are tsim_tpu's, made on the device: a survivor's row takes the
        detector reference (when ``fold_detector_reference``) and the
        observable reference (when ``fold_observable_reference``); a
        discarded row takes the detector reference on its direct detectors
        only.
        """
        self._validate_shot_args(shots, batch_size)
        n_out, nd = self._program.num_outputs, self._num_detectors
        if shots == 0:
            return np.empty((0, n_out), dtype=np.bool_)
        batch_size, shards = self._plan_batches(shots, batch_size, postselected=True)
        fold_kept, fold_dropped = np.zeros(n_out, np.bool_), np.zeros(n_out, np.bool_)
        if fold_detector_reference or fold_observable_reference:
            reference = self._reference_sample()
            if fold_detector_reference:
                fold_kept[:nd] = reference[:nd]
                fold_dropped[:nd] = reference[:nd] & self._direct_detector_mask
            if fold_observable_reference:
                fold_kept[nd:] = reference[nd:]
        post = postselection_mask & self._direct_detector_mask

        result = np.empty((shots, n_out), dtype=np.bool_)
        chunk = ceil(batch_size / len(shards))
        runs, first = [], 0
        for shard, n in zip(shards, shard_sizes(shots, len(shards))):
            if n:
                runs.append(_PostselectedShard(shard, result, first, n, chunk, nd, post, fold_kept, fold_dropped))
            first += n
        while not all(run.done for run in runs):
            live = [run for run in runs if not run.done]
            counts = [run.draw() for run in live]
            for run, count in zip(live, counts):
                with span("tsim.postsel.read"):
                    survivors = int(count)  # the chunk's one host read
                    note(survivors=survivors)
                run.take(survivors)
        for run in runs:
            run.close()
        self.last_norm_deviation = _worst((run.shard.device, run.worst) for run in runs)
        _check_norm_deviation(self.last_norm_deviation, self.evaluation)
        return result


class CompiledMeasurementSampler(_CompiledSamplerBase):
    """Samples measurement outcomes of a measurement program (a circuit
    compiles without detectors, sequential ladder)."""

    def sample(self, shots: int, *, batch_size: int | None = None) -> np.ndarray:
        with span("tsim.sample", shots=shots):
            return self._sample_batches(shots, batch_size)


def _maybe_bit_pack(array: np.ndarray, *, bit_packed: bool) -> np.ndarray:
    if not bit_packed:
        return array
    return np.packbits(array.astype(np.bool_), axis=1, bitorder="little")


class CompiledDetectorSampler(_CompiledSamplerBase):
    """Samples detector and observable outcomes of a detector program (a
    circuit compiles with its detectors, sequential ladder)."""

    _sample_detectors = True

    def _coerce_postselection_mask(self, mask) -> np.ndarray | None:
        """Validate a postselection mask; None where the prefilter has nothing
        to act on (no direct detector selected, or no component), since those
        cases sample as the plain batched path does."""
        if mask is None:
            return None
        mask = np.asarray(mask, dtype=np.bool_)
        if mask.shape != (self._num_detectors,):
            raise ValueError(
                f"postselection_mask must have shape ({self._num_detectors},), got {mask.shape}"
            )
        prefilterable = bool(self._program.components) and bool(
            (mask & self._direct_detector_mask).any()
        )
        return mask if prefilterable else None

    def sample(
        self,
        shots: int,
        *,
        batch_size: int | None = None,
        bit_packed: bool = False,
        postselection_mask: np.ndarray | None = None,
        use_detector_reference_sample: bool = False,
        use_observable_reference_sample: bool = False,
        prepend_observables: bool = False,
        append_observables: bool = False,
        separate_observables: bool = False,
    ):
        with span("tsim.sample", shots=shots):
            if separate_observables and (prepend_observables or append_observables):
                raise ValueError(
                    "separate_observables=True is mutually exclusive with the "
                    "prepend/append observable layouts"
                )
            if (
                postselection_mask is None
                and not (use_detector_reference_sample or use_observable_reference_sample)
                and not prepend_observables
                and self.direct_route == "native_frame"
            ):
                # The frame engine gives detectors and observables in their
                # final (bit-packed) layout; det_bias made the detectors absolute.
                _, det, obs = self._native_frame_sampler().sample(
                    shots, bit_packed=bit_packed, include_measurements=False
                )
                if separate_observables:
                    return det, obs
                if append_observables:
                    if bit_packed:
                        joined = np.concatenate(
                            [
                                np.unpackbits(det, axis=1, bitorder="little")[:, : self._num_detectors],
                                np.unpackbits(obs, axis=1, bitorder="little")[
                                    :, : self._program.num_outputs - self._num_detectors
                                ],
                            ],
                            axis=1,
                        ).astype(bool)
                        return _maybe_bit_pack(joined, bit_packed=True)
                    return np.concatenate([det, obs], axis=1)
                return det
            prefilter_mask = self._coerce_postselection_mask(postselection_mask)
            nd = self._num_detectors
            if prefilter_mask is None:
                # Every shot is evaluated; the reference folds apply to all of them.
                fold = None
                if (use_detector_reference_sample or use_observable_reference_sample) and shots:
                    reference = self._reference_sample()
                    fold = np.zeros_like(reference)
                    if use_detector_reference_sample:
                        fold[:nd] = reference[:nd]
                    if use_observable_reference_sample:
                        fold[nd:] = reference[nd:]
                samples = self._sample_batches(shots, batch_size, fold)
            else:
                # The detector fold decides which shots the prefilter discards;
                # discarded shots are never evaluated, so the observable fold
                # touches the survivors only.
                samples = self._sample_batches_with_postselection(
                    shots,
                    batch_size,
                    postselection_mask=prefilter_mask,
                    fold_detector_reference=use_detector_reference_sample,
                    fold_observable_reference=use_observable_reference_sample,
                )
            det = samples[:, :nd]
            obs = samples[:, nd:]
            if prepend_observables and append_observables:
                return _maybe_bit_pack(np.concatenate([obs, det, obs], axis=1), bit_packed=bit_packed)
            if append_observables:
                return _maybe_bit_pack(samples, bit_packed=bit_packed)
            if prepend_observables:
                return _maybe_bit_pack(np.concatenate([obs, det], axis=1), bit_packed=bit_packed)
            if separate_observables:
                return (
                    _maybe_bit_pack(det, bit_packed=bit_packed),
                    _maybe_bit_pack(obs, bit_packed=bit_packed),
                )
            return _maybe_bit_pack(det, bit_packed=bit_packed)


class CompiledStateProbs(_CompiledSamplerBase):
    """Joint-mode probability estimator: P(state | noise sample), evaluated exactly.

    Counterpart of ``tsim_tpu.sampler.CompiledStateProbs``. Each component
    of a joint-mode program has two rungs, its norm and its joint circuit;
    the noise comes from the device channel sampler on this object's
    generator. A circuit compiles in joint mode, with its detectors as
    outputs where ``sample_detectors``.
    """

    _mode = "joint"

    def __init__(
        self, source, *, sample_detectors: bool = False, strategy: str = "cat5",
        seed: int | None = None, device=None, mesh="auto",
    ):
        self._sample_detectors = sample_detectors
        super().__init__(
            source, seed=seed, device=device, evaluation="exact", strategy=strategy, mesh=mesh
        )
        for comp in self._program.components:
            if len(comp.compiled_scalar_graphs) != 2:
                raise ValueError(
                    "a state-probability program has two rungs (norm, joint) per component, "
                    f"got {len(comp.compiled_scalar_graphs)}"
                )

    def _options(self) -> dict:
        return {}

    def probability_of(self, state: np.ndarray, *, batch_size: int) -> np.ndarray:
        """P(state | f) for ``batch_size`` noise samples f: (batch_size,) float32.

        The noise is drawn on the first device from this object's generator,
        the stream an unsharded estimator draws; with a mesh its rows are
        split over the mesh, evaluated where each shard lies and gathered,
        so sharded and unsharded give the same values on the same seed."""
        with span("tsim.sample", shots=batch_size):
            if batch_size < 1:
                raise ValueError(f"batch_size must be at least 1, got {batch_size}")
            expected = self._program.num_outputs
            state = np.asarray(state)
            if state.shape != (expected,):
                raise ValueError(f"state must have shape ({expected},), got {state.shape}")
            f_samples = self._device_channels.sample(self._generator, batch_size)
            devices = [shard.device for shard in self._shards_for(batch_size)]
            if len(devices) == 1:
                return self._probability_body(f_samples, state).cpu().numpy()
            parts = []
            for device, f in zip(devices, torch.tensor_split(f_samples, len(devices))):
                if f.shape[0]:
                    with on_device(device):
                        parts.append(self._probability_body(f.to(device), state, self._replicas[device]))
            return np.concatenate([p.cpu().numpy() for p in parts])

    def _probability_body(self, f_samples: torch.Tensor, state, tables: ProgramTables | None = None) -> torch.Tensor:
        """P(state | f) per row of (B, num_f) uint8 ``f_samples``: the direct
        bits' agreement times, per component, |joint| / |norm| with the
        component's state bits tiled behind its f-bits (``tables``: the
        sampler's own by default, or a replica on ``f_samples``' device)."""
        tables = self._tables if tables is None else tables
        batch = f_samples.shape[0]
        device = f_samples.device
        state = torch.as_tensor(np.asarray(state, np.uint8), device=device)
        p_norm = torch.ones(batch, dtype=torch.float32, device=device)
        p_joint = torch.ones(batch, dtype=torch.float32, device=device)
        if len(tables.direct_f_indices):
            targets = state[tables.direct_output_order]
            p_joint = p_joint * (tables.direct_bits(f_samples) == targets).all(dim=1)
        for comp in tables.components:
            norm, joint = comp.rungs
            f_selected = static_take_columns(f_samples, comp.f_selection)
            p_norm = p_norm * evaluate_abs_sample(norm, f_selected)
            tiled = state[comp.output_indices].expand(batch, -1)
            p_joint = p_joint * evaluate_abs_sample(joint, torch.cat([f_selected, tiled], dim=1))
        return p_joint / p_norm
