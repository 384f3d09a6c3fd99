"""The compiled program as plain data: dataclasses, conversion and ``.npz`` I/O.

The port has no compiler of its own yet. A program compiled by
``tsim_tpu`` (which needs JAX) is converted with :func:`from_reference`,
written once with :func:`save_npz`, and loaded with :func:`load_npz` on a
machine that has no JAX. Field names match ``tsim_tpu``'s own types
(``core/types.py``, ``compile/compile.py``, ``compile/terms.py``), so code
written against one reads the other. Every leaf is a numpy array.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, fields

import numpy as np

FORMAT_VERSION = 2  # 2: optional replay arrays


@dataclass(frozen=True)
class NodePhases:
    """Product of ``1 + w^(phase + 4 parity)`` terms: phases (T, G), params (T, G, P), counts (G,)."""

    phases: np.ndarray
    params: np.ndarray
    counts: np.ndarray


@dataclass(frozen=True)
class HalfPiPhases:
    """``w^(sum coeff * parity)``: coeffs (T, G) in {0, 2, 4, 6}, params (T, G, P)."""

    coeffs: np.ndarray
    params: np.ndarray


@dataclass(frozen=True)
class PiProducts:
    """``(-1)^(sum psi * phi)``, each side a constant XOR a parity."""

    psi_const: np.ndarray
    psi_params: np.ndarray
    phi_const: np.ndarray
    phi_params: np.ndarray


@dataclass(frozen=True)
class PhasePairs:
    """Product of ``1 + w^a + w^b - w^(a+b)`` terms."""

    alpha: np.ndarray
    alpha_params: np.ndarray
    beta: np.ndarray
    beta_params: np.ndarray
    counts: np.ndarray


@dataclass(frozen=True)
class ScalarPrefactor:
    """Per-graph ``w^phase * floatfactor * 2^power2 * approximate factor``."""

    phase_indices: np.ndarray  # (G,) 0-7
    floatfactor: np.ndarray  # (G, 4) exact Z[w] coefficients
    power2: np.ndarray  # (G,)
    approximate_floatfactors: np.ndarray  # (G, 2) float32 (re, im)
    has_approximate_floatfactors: bool = False


@dataclass(frozen=True)
class CompiledScalarGraphs:
    """One rung of a ladder: a batch of scalar graphs as term families."""

    num_graphs: int
    n_params: int
    node_phases: NodePhases
    halfpi_phases: HalfPiPhases
    pi_products: PiProducts
    phase_pairs: PhasePairs
    prefactor: ScalarPrefactor


@dataclass(frozen=True)
class CompiledComponent:
    """A connected component and its plugged-circuit ladder [norm, 1 plugged, ...]."""

    output_indices: tuple
    f_selection: tuple
    compiled_scalar_graphs: tuple


@dataclass(frozen=True)
class CompiledProgram:
    """Direct outputs plus components, as ``tsim_tpu.core.types.CompiledProgram``."""

    components: tuple
    direct_f_indices: np.ndarray
    direct_flips: np.ndarray
    output_order: np.ndarray
    output_reindex: np.ndarray | None
    num_outputs: int
    num_detectors: int
    direct_const_mask: np.ndarray | None = None


@dataclass(frozen=True)
class Channel:
    """A simplified noise channel: outcome probabilities over its signature ids."""

    probs: np.ndarray
    unique_col_ids: tuple


@dataclass(frozen=True)
class NoiseModel:
    """The simplified channels and the (num_signatures, num_f) signature matrix."""

    channels: tuple
    signature_matrix: np.ndarray


@dataclass(frozen=True)
class ExportedProgram:
    """Everything a sampler needs: program, noise, and optional reference data.

    ``reference_means`` holds per-output means sampled by ``tsim_tpu`` at
    ``meta["reference_shots"]`` shots, for physics checks where JAX is absent.
    ``replay`` holds named arrays that ``tsim_tpu`` produced from given
    randomness (noise uniforms, draw uniforms, and what it computed from
    them), which the port must reproduce; ``meta`` describes them.
    """

    program: CompiledProgram
    noise: NoiseModel
    num_detectors: int
    reference_means: np.ndarray | None = None
    meta: dict = field(default_factory=dict)
    replay: dict = field(default_factory=dict)


_FAMILIES = (
    ("node_phases", NodePhases),
    ("halfpi_phases", HalfPiPhases),
    ("pi_products", PiProducts),
    ("phase_pairs", PhasePairs),
)


def _arrays_of(cls, obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name)) for f in fields(cls)}


def rung_from_reference(csg) -> CompiledScalarGraphs:
    """One ``tsim_tpu`` ``CompiledScalarGraphs`` (a ladder rung) as numpy dataclasses."""
    fams = {name: cls(**_arrays_of(cls, getattr(csg, name))) for name, cls in _FAMILIES}
    pf = csg.prefactor
    prefactor = ScalarPrefactor(
        phase_indices=np.asarray(pf.phase_indices),
        floatfactor=np.asarray(pf.floatfactor),
        power2=np.asarray(pf.power2),
        approximate_floatfactors=np.asarray(pf.approximate_floatfactors),
        has_approximate_floatfactors=bool(pf.has_approximate_floatfactors),
    )
    return CompiledScalarGraphs(
        num_graphs=int(csg.num_graphs), n_params=int(csg.n_params),
        prefactor=prefactor, **fams,
    )


def _optional(a):
    return None if a is None else np.asarray(a)


def from_reference(program, channel_sampler, num_detectors: int) -> ExportedProgram:
    """Convert a ``tsim_tpu`` ``CompiledProgram`` and ``ChannelSampler``.

    Both are read by attribute only (duck-typed), so this module imports
    nothing from ``tsim_tpu``; every leaf becomes a numpy array.
    """
    components = tuple(
        CompiledComponent(
            output_indices=tuple(int(i) for i in comp.output_indices),
            f_selection=tuple(int(i) for i in comp.f_selection),
            compiled_scalar_graphs=tuple(rung_from_reference(c) for c in comp.compiled_scalar_graphs),
        )
        for comp in program.components
    )
    prog = CompiledProgram(
        components=components,
        direct_f_indices=np.asarray(program.direct_f_indices),
        direct_flips=np.asarray(program.direct_flips),
        output_order=np.asarray(program.output_order),
        output_reindex=_optional(program.output_reindex),
        num_outputs=int(program.num_outputs),
        num_detectors=int(program.num_detectors),
        direct_const_mask=_optional(program.direct_const_mask),
    )
    return ExportedProgram(
        program=prog, noise=noise_from_reference(channel_sampler),
        num_detectors=int(num_detectors),
    )


def noise_from_reference(channel_sampler) -> NoiseModel:
    """The simplified channels and signature matrix of a ``tsim_tpu`` ``ChannelSampler``."""
    return NoiseModel(
        channels=tuple(
            Channel(
                probs=np.asarray(ch.probs, np.float64),
                unique_col_ids=tuple(int(i) for i in ch.unique_col_ids),
            )
            for ch in channel_sampler.channels
        ),
        signature_matrix=np.asarray(channel_sampler.signature_matrix, np.uint8),
    )


# ------------------------------------------------------------------ npz I/O

def flatten(exported: ExportedProgram) -> tuple[dict, dict]:
    """(arrays, header): arrays keyed by dotted path, scalars in the header."""
    prog = exported.program
    arrays: dict[str, np.ndarray] = {}
    comps = []
    for ci, comp in enumerate(prog.components):
        rungs = []
        for ri, csg in enumerate(comp.compiled_scalar_graphs):
            base = f"c{ci}.r{ri}"
            for name, cls in _FAMILIES:
                for k, v in _arrays_of(cls, getattr(csg, name)).items():
                    arrays[f"{base}.{name}.{k}"] = v
            pf = csg.prefactor
            for k in ("phase_indices", "floatfactor", "power2", "approximate_floatfactors"):
                arrays[f"{base}.prefactor.{k}"] = np.asarray(getattr(pf, k))
            rungs.append({
                "num_graphs": csg.num_graphs,
                "n_params": csg.n_params,
                "has_approximate_floatfactors": bool(pf.has_approximate_floatfactors),
            })
        comps.append({
            "output_indices": list(comp.output_indices),
            "f_selection": list(comp.f_selection),
            "rungs": rungs,
        })
    for k in ("direct_f_indices", "direct_flips", "output_order"):
        arrays[f"program.{k}"] = np.asarray(getattr(prog, k))
    for k in ("output_reindex", "direct_const_mask"):
        if getattr(prog, k) is not None:
            arrays[f"program.{k}"] = np.asarray(getattr(prog, k))
    chans = exported.noise.channels
    arrays["noise.probs"] = np.concatenate([c.probs for c in chans]) if chans else np.zeros(0)
    arrays["noise.col_ids"] = np.asarray(
        [i for c in chans for i in c.unique_col_ids], np.int64
    )
    arrays["noise.num_bits"] = np.asarray([len(c.unique_col_ids) for c in chans], np.int64)
    arrays["noise.signature_matrix"] = exported.noise.signature_matrix
    if exported.reference_means is not None:
        arrays["reference_means"] = np.asarray(exported.reference_means, np.float64)
    for k, v in exported.replay.items():
        arrays[f"replay.{k}"] = np.asarray(v)
    header = {
        "format_version": FORMAT_VERSION,
        "components": comps,
        "num_outputs": prog.num_outputs,
        "program_num_detectors": prog.num_detectors,
        "num_detectors": exported.num_detectors,
        "meta": exported.meta,
    }
    return arrays, header


def leaf_differences(a: ExportedProgram, b: ExportedProgram) -> list[str]:
    """The names (``flatten``'s keys) of the leaves and header entries in
    which the programs, noise models and detector counts of ``a`` and ``b``
    differ: a leaf differs in dtype, shape or any value. Reference data,
    replays and meta are not compared."""
    (aa, ah), (ba, bh) = (
        flatten(ExportedProgram(program=e.program, noise=e.noise, num_detectors=e.num_detectors))
        for e in (a, b)
    )
    names = sorted(set(aa) ^ set(ba))
    names += [
        k for k in sorted(set(aa) & set(ba))
        if aa[k].dtype != ba[k].dtype or aa[k].shape != ba[k].shape or not np.array_equal(aa[k], ba[k])
    ]
    return names + [f"header.{k}" for k in sorted(ah) if ah[k] != bh.get(k)]


def save_npz(path, exported: ExportedProgram) -> None:
    """Write ``exported`` as one ``.npz`` of arrays plus a JSON header."""
    write_npz(path, *flatten(exported))


def write_npz(path, arrays: dict, header: dict) -> None:
    """Write named arrays and a JSON-able header as one ``.npz`` file at
    ``path``, whatever its suffix."""
    blob = np.frombuffer(json.dumps(header, sort_keys=True).encode(), np.uint8)
    with open(path, "wb") as fh:
        np.savez_compressed(fh, __header__=blob, **arrays)


def read_npz(path) -> tuple[dict, dict]:
    """(arrays, header) of a file written by :func:`write_npz` (no pickle is
    involved), checked for this module's format version."""
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    header = json.loads(arrays.pop("__header__").tobytes().decode())
    if header["format_version"] != FORMAT_VERSION:
        raise ValueError(
            f"{path}: format version {header['format_version']}, expected {FORMAT_VERSION}"
        )
    return arrays, header


def load_npz(path) -> ExportedProgram:
    """Read a file written by :func:`save_npz`."""
    return unflatten(*read_npz(path))


def unflatten(arrays: dict, header: dict) -> ExportedProgram:
    """The inverse of :func:`flatten`."""
    components = []
    for ci, comp in enumerate(header["components"]):
        rungs = []
        for ri, meta in enumerate(comp["rungs"]):
            base = f"c{ci}.r{ri}"
            fams = {
                name: cls(**{f.name: arrays[f"{base}.{name}.{f.name}"] for f in fields(cls)})
                for name, cls in _FAMILIES
            }
            pf = ScalarPrefactor(
                phase_indices=arrays[f"{base}.prefactor.phase_indices"],
                floatfactor=arrays[f"{base}.prefactor.floatfactor"],
                power2=arrays[f"{base}.prefactor.power2"],
                approximate_floatfactors=arrays[f"{base}.prefactor.approximate_floatfactors"],
                has_approximate_floatfactors=meta["has_approximate_floatfactors"],
            )
            rungs.append(CompiledScalarGraphs(
                num_graphs=meta["num_graphs"], n_params=meta["n_params"],
                prefactor=pf, **fams,
            ))
        components.append(CompiledComponent(
            output_indices=tuple(comp["output_indices"]),
            f_selection=tuple(comp["f_selection"]),
            compiled_scalar_graphs=tuple(rungs),
        ))
    program = CompiledProgram(
        components=tuple(components),
        direct_f_indices=arrays["program.direct_f_indices"],
        direct_flips=arrays["program.direct_flips"],
        output_order=arrays["program.output_order"],
        output_reindex=arrays.get("program.output_reindex"),
        num_outputs=header["num_outputs"],
        num_detectors=header["program_num_detectors"],
        direct_const_mask=arrays.get("program.direct_const_mask"),
    )
    bounds = np.concatenate([[0], np.cumsum(2 ** arrays["noise.num_bits"])])
    id_bounds = np.concatenate([[0], np.cumsum(arrays["noise.num_bits"])])
    channels = tuple(
        Channel(
            probs=arrays["noise.probs"][bounds[i] : bounds[i + 1]],
            unique_col_ids=tuple(
                int(c) for c in arrays["noise.col_ids"][id_bounds[i] : id_bounds[i + 1]]
            ),
        )
        for i in range(len(arrays["noise.num_bits"]))
    )
    noise = NoiseModel(channels=channels, signature_matrix=arrays["noise.signature_matrix"])
    return ExportedProgram(
        program=program,
        noise=noise,
        num_detectors=header["num_detectors"],
        reference_means=arrays.get("reference_means"),
        meta=header["meta"],
        replay={k[len("replay."):]: v for k, v in arrays.items() if k.startswith("replay.")},
    )

