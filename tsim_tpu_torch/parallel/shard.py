"""Multi-device sampling: shard the shot axis over a mesh of torch devices.

Counterpart of ``tsim_tpu/parallel/shard.py``. Compiled tables are small,
so every device of the mesh holds its own copy (one ``ProgramTables`` a
device); the shot axis of a batch is split into contiguous shards, one per
mesh entry, which differ by at most one row. Each shard draws from a
generator of its own, seeded from (seed, shard index): the counterpart of
``fold_in(key, axis_index)``. The norm monitor's reduction over shards (the
counterpart of ``jax.lax.pmax``) is a max of the shards' deviations.

As in ``tsim_tpu`` one process drives every device: one host thread
enqueues each shard's work on its own device, and the launches run
asynchronously. No ``torch.distributed``, NCCL or ``DataParallel`` is
involved.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import numpy as np
import torch


def indexed_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index: "cuda" names the
    current card (left as it is where there is no card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _mesh_device(device) -> torch.device:
    device = indexed_device(device)
    if device.type == "cuda" and not (
        torch.cuda.is_available() and device.index < torch.cuda.device_count()
    ):
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise RuntimeError(f"mesh device {device} is not available: {count} CUDA devices are visible")
    return device


@dataclass(frozen=True, init=False)
class ShotMesh:
    """A one-axis mesh of torch devices over which the shot axis is sharded.

    ``devices`` holds each entry as a ``torch.device`` with its index
    ("cuda" becomes "cuda:<current>"); a CUDA device that is not visible
    raises. A device may repeat: its entries are replicas, shards that share
    the device, its tables and its current stream. Replicas exist for tests
    and for checks of the sharded path on one card; they add no throughput.
    """

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...]

    def __init__(self, devices, axis_name: str = "shots"):
        resolved = tuple(_mesh_device(d) for d in devices)
        if not resolved:
            raise ValueError("a shot mesh needs at least one device")
        object.__setattr__(self, "devices", resolved)
        object.__setattr__(self, "axis_names", (axis_name,))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> tuple[torch.device, ...]:
        """The mesh's devices without repeats, in order of first entry."""
        return tuple(dict.fromkeys(self.devices))


def make_shot_mesh(devices=None, axis_name: str = "shots") -> ShotMesh:
    """A mesh over ``devices``, by default every visible CUDA device; with
    no CUDA device and no ``devices`` it raises (there is no CPU fallback)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible: the default shot mesh spans the CUDA devices; "
                "name the devices to shard over (for instance CPU replicas) explicitly"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return ShotMesh(devices, axis_name)


def shard_sizes(rows: int, n: int) -> list[int]:
    """Rows of each of ``n`` shards of ``rows``, as ``torch.tensor_split``
    cuts them: the first ``rows % n`` shards hold one row more."""
    return [rows // n + (i < rows % n) for i in range(n)]


def shard_seed(seed: int, index: int) -> int:
    """Seed of shard ``index`` of a sampler seeded with ``seed``, through
    numpy's ``SeedSequence``: no two shards share a stream, and none is the
    unsharded stream of ``seed``."""
    return int(np.random.SeedSequence((seed, index)).generate_state(1, np.uint64)[0])


def shard_generators(seed: int, mesh: ShotMesh) -> list[torch.Generator]:
    """One generator a mesh entry, on its device, seeded by :func:`shard_seed`."""
    generators = []
    for i, device in enumerate(mesh.devices):
        generator = torch.Generator(device=device)
        generator.manual_seed(shard_seed(seed, i))
        generators.append(generator)
    return generators


def replicate(tables, devices) -> dict:
    """{device: ``tables`` on it}: the tables themselves on their own device
    and a copy on each other one of ``devices``."""
    home = tables.direct_f_indices.device
    return {d: tables if d == home else copy.deepcopy(tables).to(d) for d in devices}


def sharded_sample_program(replicas, mesh: ShotMesh, f_params, generators, uniforms=None):
    """Sample every output with the shot axis of ``f_params`` split over ``mesh``.

    ``replicas`` maps each distinct device of the mesh to its
    ``ProgramTables``; ``generators`` holds one generator a mesh entry.
    ``f_params`` (B, num_f) uint8 is cut with ``tensor_split``; each shard
    runs ``sample_program_with_deviation`` on its own device with its own
    tables and generator. ``uniforms``, if given (one (B,) float32 tensor a
    rung, as ``sample_program_with_deviation`` takes them), is cut the same
    way. Returns ((B, num_outputs) uint8 rows in shot order and (1,) the max
    of the shards' norm deviations, both on the mesh's first device).
    """
    from ..sampler import on_device, sample_program_with_deviation

    if len(generators) != mesh.size:
        raise ValueError(f"{len(generators)} generators for a mesh of {mesh.size}")
    rows = torch.tensor_split(f_params, mesh.size)
    draws = None if uniforms is None else [torch.tensor_split(u, mesh.size) for u in uniforms]
    outs, devs = [], []
    for i, (device, generator, f) in enumerate(zip(mesh.devices, generators, rows)):
        if f.shape[0] == 0:
            continue
        with on_device(device):
            shard_draws = None if draws is None else [d[i] for d in draws]
            out, dev = sample_program_with_deviation(replicas[device], f.to(device), generator, shard_draws)
        outs.append(out)
        devs.append(dev)
    first = mesh.devices[0]
    if not outs:
        empty = torch.zeros((0, replicas[first].num_outputs), dtype=torch.uint8, device=first)
        return empty, torch.zeros((1,), dtype=torch.float32, device=first)
    worst = torch.cat([d.to(first) for d in devs]).max().reshape(1)
    return torch.cat([o.to(first) for o in outs]), worst


def sharded_sampler_step(program_or_tables, mesh: ShotMesh):
    """A closure ``run(f_params, generators, uniforms=None)`` of
    :func:`sharded_sample_program` over a program (compiled into f32 tables)
    or a ``ProgramTables``, replicated once on every distinct device."""
    from ..sampler import ProgramTables

    tables = program_or_tables
    if not isinstance(tables, ProgramTables):
        tables = ProgramTables(program_or_tables).to(mesh.devices[0])
    replicas = replicate(tables, mesh.distinct)

    def run(f_params, generators, uniforms=None):
        return sharded_sample_program(replicas, mesh, f_params, generators, uniforms)

    return run
