"""The sampling evaluator: the f32 plain PyTorch version and the dispatch.

Counterpart of the dispatch half of ``tsim_tpu``'s
``compile/pallas_sample.py`` (``evaluate_abs_sample_f32``,
``evaluate_abs_sample``, ``norm_deviation_tolerance``). Per shot row and
per graph the f32 evaluator forms the complex f32 product of the four
term families times the prefolded prefactor, sums over graphs, and
returns the magnitude rescaled by ``2^bias``.

Each rung is evaluated in one of two modes, chosen when its tables are
built (:func:`rung_tables`): "f32" (the sampling kernel) or "exact" (the
exact kernels, ``compile/exact_eval.py``). A rung that fails
``sample_eligible`` is always exact; ``evaluation="exact"`` makes every
rung exact, as ``tsim_tpu``'s ``TSIM_TPU_SAMPLE_EVAL=exact`` does.

A CPU tensor runs the plain version; a CUDA tensor runs the hand-written
kernels (``kernels/``), which raise if they cannot be built or launched.
The first f32 launch on each device runs the kernels' start-up self-test
(:func:`ensure_self_test`, the counterpart of tsim_tpu's ``_tpack_probe``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import sample_eval as _kernel
from ..parallel.shard import indexed_device
from ..program_io import (
    CompiledScalarGraphs,
    HalfPiPhases,
    NodePhases,
    PhasePairs,
    PiProducts,
    ScalarPrefactor,
)
from .exact_eval import bytes_per_row as exact_bytes_per_row, evaluate_abs_exact
from .exact_tables import ExactTables
from .sample_tables import _SQRT_HALF, SampleTables, sample_eligible, unpack_words

EVALUATIONS = ("f32", "exact")


def check_evaluation(evaluation: str) -> str:
    if evaluation not in EVALUATIONS:
        raise ValueError(f"evaluation must be one of {EVALUATIONS}, got {evaluation!r}")
    return evaluation


def norm_deviation_tolerance(evaluation: str = "f32") -> float:
    """Warn threshold of the sampler's normalization monitor.

    The exact path deviates only by the final float conversion (about
    1e-7); f32 products accumulate about ``T * 2^-23`` relative error plus
    cancellation in the graph sum, so f32 mode gets a wider band.
    """
    return 3e-3 if check_evaluation(evaluation) == "f32" else 1e-5


def rung_tables(
    circuit, evaluation: str = "f32", per_term: bool | None = None
) -> SampleTables | ExactTables:
    """The evaluator tables of one rung: exact in exact mode or when the rung
    fails ``sample_eligible``, f32 otherwise (``per_term`` as in
    :class:`SampleTables`)."""
    if check_evaluation(evaluation) == "exact" or not sample_eligible(circuit):
        return ExactTables(circuit)
    return SampleTables(circuit, per_term)


# Peak rates of one H100 SXM (NVIDIA's data sheet): float32 outside the
# tensor cores; int32 adds, multiplies and logic at 64 results a clock on
# each of 132 SMs at 1.98 GHz. The sampler's "auto" rule uses only ratios
# of least_seconds_per_row, so on another card they weigh the two types.
F32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def least_seconds_per_row(tables: SampleTables | ExactTables) -> float:
    """The least time a card could take for one row of one evaluation of
    ``tables``: its term-graph operations over the peak rate of their type,
    as ``chip_smoke.py``'s ``f32_bound``, ``exact_bound`` and
    ``approx_bound`` count them, but over every term slot of the tables
    (``dims``) rather than the live terms. f32: 6 float32 operations a
    node-phase and phase-pair slot, 12 a graph; exact: 4 int32 operations a
    node-phase slot, 12 a phase-pair slot, 32 a graph; the approximate
    finisher: 1 and 12 a slot."""
    t1, _, _, t4 = tables.dims
    g = tables.num_graphs
    if not isinstance(tables, ExactTables):
        return g * (6 * (t1 + t4) + 12) / F32_OPS_PER_S
    if tables.approximate:
        return g * (t1 + 12 * t4) / INT32_OPS_PER_S
    return g * (4 * t1 + 12 * t4 + 32) / INT32_OPS_PER_S


def _rot_staged(re, im, k):
    """(re, im) * w^k for an int32 tensor k in [0, 8), staged on k's bits."""
    b0 = (k & 1) == 1
    nre = (re - im) * float(_SQRT_HALF)
    nim = (re + im) * float(_SQRT_HALF)
    re, im = torch.where(b0, nre, re), torch.where(b0, nim, im)
    b1 = (k & 2) == 2
    re, im = torch.where(b1, -im, re), torch.where(b1, re, im)
    b2 = (k & 4) == 4
    return torch.where(b2, -re, re), torch.where(b2, -im, im)


CHUNK_BYTES = 1 << 30  # largest (rows, T * G) float32 parity array of one row chunk


def plain_bytes_per_row(tables: SampleTables) -> int:
    """Bytes a row that the plain version holds at its peak on the rows of
    one chunk (a batch of more rows than a chunk holds less a row), its
    result included: the rows as float32, the parity arrays of every
    family alive together ((B, T, G) float32, two for the pi products and
    phase pairs) and two more of the widest while :func:`_product_sum`'s
    ``parities`` forms one, twelve (B, G) float32 arrays (the running
    product and the factors' temporaries), the (B, 2) sum and (B,) magnitude."""
    t1, t2, t3, t4 = tables.dims
    G = tables.num_graphs
    return 4 * tables.n_params + 4 * G * (t1 + t2 + 2 * t3 + 2 * t4 + 2 * max(tables.dims)) + 48 * G + 12


def bytes_per_row(tables: SampleTables | ExactTables, device: torch.device) -> int:
    """Bytes a row that one evaluation of ``tables`` (:func:`evaluate_abs_sample`)
    holds at its peak on ``device``, its (B,) float32 result included. On a
    card the f32 kernels write (B, 2) float32 and :func:`_magnitude` adds
    three (B,) temporaries: 20. On the CPU, :func:`plain_bytes_per_row`.
    Exact tables: ``compile/exact_eval.py::bytes_per_row``."""
    if isinstance(tables, ExactTables):
        return exact_bytes_per_row(tables, device)
    return plain_bytes_per_row(tables) if device.type == "cpu" else 20


def sample_product_sum_reference(tables: SampleTables, x: torch.Tensor, *, with_mass: bool = False):
    """Plain PyTorch version of the sampling kernels: (B, P) uint8 -> (B, 2) f32.

    Follows ``_product_body_sample_packed`` (whose per-term twin
    ``_product_body_sample`` computes the same function) with the graph axis
    summed. Parities are a float32 matmul mod 2 (row sums are at most P,
    exact in f32), because CUDA tensors have no integer matmul. Rows are
    evaluated in chunks whose parity arrays stay within CHUNK_BYTES; each
    row's result does not depend on the chunking.

    ``with_mass=True`` also returns each row's mass, (B,) f32: the sum over
    graphs of each graph's |product|. It is the scale of the f32 rounding
    in the graph sum, which may cancel to (near) zero, so a kernel is held
    to the plain version relative to it.
    """
    per_row = 4 * max(1, *tables.dims) * max(1, tables.num_graphs)
    rows = max(1, CHUNK_BYTES // per_row)
    parts = [
        _product_sum(tables, x[i : i + rows], with_mass) for i in range(0, max(x.shape[0], 1), rows)
    ]
    total = torch.cat([p[0] for p in parts])
    return (total, torch.cat([p[1] for p in parts])) if with_mass else total


def _product_sum(tables: SampleTables, x: torch.Tensor, with_mass: bool):
    """((B, 2) graph sums, (B,) masses or None) of the rows ``x``."""
    t1, t2, t3, t4 = tables.dims
    v = tables.views()
    xf = x.to(torch.float32)
    B, G = x.shape[0], tables.num_graphs

    def parities(words):
        t = words.shape[0]
        bits = unpack_words(words, tables.n_params).to(torch.float32)  # (T, G, P)
        prod = xf @ bits.reshape(t * G, -1).T  # (B, T*G)
        return (prod - 2.0 * torch.floor(prod * 0.5)).reshape(B, t, G)

    re = torch.ones((B, G), dtype=torch.float32, device=x.device)
    im = torch.zeros((B, G), dtype=torch.float32, device=x.device)

    if t1:
        par = parities(v["np_words"])
        for t in range(t1):
            c, s, p = v["np_cos"][t], v["np_sin"][t], par[:, t]
            fr = (1.0 + c) - (2.0 * c) * p
            fi = s - (2.0 * s) * p
            re, im = re * fr - im * fi, re * fi + im * fr

    if t2:
        par = parities(v["hp_words"])
        coeffs = v["hp_coeffs"].to(torch.float32)
        total = torch.zeros((B, G), dtype=torch.float32, device=x.device)
        for t in range(t2):
            total = total + coeffs[t] * par[:, t]
        re, im = _rot_staged(re, im, total.to(torch.int32) & 7)

    if t3:
        par_psi = parities(v["pp_psi_words"])
        par_phi = parities(v["pp_phi_words"])
        psi_c = v["pp_psi_c"].to(torch.float32)
        phi_c = v["pp_phi_c"].to(torch.float32)
        s = torch.zeros((B, G), dtype=torch.float32, device=x.device)
        for t in range(t3):
            pc, qc = psi_c[t], phi_c[t]
            psi = pc + (1.0 - 2.0 * pc) * par_psi[:, t]
            phi = qc + (1.0 - 2.0 * qc) * par_phi[:, t]
            s = s + psi * phi
        sign = 1.0 - 2.0 * (s - 2.0 * torch.floor(s * 0.5))
        re, im = re * sign, im * sign

    if t4:
        par_a = parities(v["qp_alpha_words"])
        par_b = parities(v["qp_beta_words"])
        for t in range(t4):
            s_a = 1.0 - 2.0 * par_a[:, t]
            s_b = 1.0 - 2.0 * par_b[:, t]
            s_g = s_a * s_b
            fr = 1.0 + s_a * v["qp_ca"][t] + s_b * v["qp_cb"][t] - s_g * v["qp_cg"][t]
            fi = s_a * v["qp_sa"][t] + s_b * v["qp_sb"][t] - s_g * v["qp_sg"][t]
            re, im = re * fr - im * fi, re * fi + im * fr

    pr, pi_ = v["pre"][0], v["pre"][1]
    re, im = re * pr - im * pi_, re * pi_ + im * pr
    mass = torch.sqrt(re**2 + im**2).sum(dim=1) if with_mass else None
    return torch.stack([re.sum(dim=1), im.sum(dim=1)], dim=1), mass


def _magnitude(total: torch.Tensor, bias: int) -> torch.Tensor:
    """|re + i im| * 2^bias, the rescale in two steps that each stay a normal f32."""
    mag = torch.sqrt(total[:, 0] ** 2 + total[:, 1] ** 2)
    if bias:
        h = bias // 2
        mag = mag * float(2.0**h) * float(2.0 ** (bias - h))
    return mag


def _check_input(tables: SampleTables, x: torch.Tensor) -> None:
    if x.dtype != torch.uint8 or x.dim() != 2 or x.shape[1] != tables.n_params:
        raise ValueError(
            f"expected (B, {tables.n_params}) uint8 parameter rows, got "
            f"{tuple(x.shape)} {x.dtype}"
        )


def evaluate_abs_sample_f32(tables: SampleTables, x: torch.Tensor) -> torch.Tensor:
    """|amplitude| per row: plain version on the CPU, CUDA kernel otherwise
    (after the device's self-test)."""
    _check_input(tables, x)
    if x.device.type == "cpu":
        total = sample_product_sum_reference(tables, x)
    else:
        ensure_self_test(x.device)
        total = _kernel.sample_product_sum(tables, x.contiguous())
    return _magnitude(total, tables.bias)


def evaluate_abs_sample(tables: SampleTables | ExactTables, x: torch.Tensor) -> torch.Tensor:
    """Sampling-mode evaluation of one rung: (B, P) uint8 -> (B,) float32.

    Exact tables take the exact evaluator; f32 tables the f32 one.
    """
    if tables.num_graphs == 0:
        return torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    if isinstance(tables, ExactTables):
        return evaluate_abs_exact(tables, x)
    if not tables.eligible:
        raise ValueError(
            "this rung fails sample_eligible (its products exceed the f32 range): "
            "build its tables with rung_tables(), which evaluates it exactly"
        )
    return evaluate_abs_sample_f32(tables, x)


# ------------------------------------------------------------ K4 self-test

# The probe: graphs of the wide and of the small tables, parameters, rows,
# terms per family, and its tolerance relative to the row's mass.
PROBE_GRAPHS = {"wide": 128, "small": 8}
PROBE_PARAMS, PROBE_ROWS, PROBE_TERMS = 8, 128, (2, 2, 2, 2)
PROBE_RTOL, PROBE_ATOL = 1e-5, 1e-8

# Self-test outcome per device: None once passed, else the failure message.
_self_tested: dict[str, str | None] = {}


def synthetic_rung(seed: int, num_graphs: int, n_params: int, terms=(2, 2, 2, 2)) -> CompiledScalarGraphs:
    """A seeded rung of ``num_graphs`` graphs over ``n_params`` parameters
    with ``terms = (T1, T2, T3, T4)`` term slots per family, every family
    live (each graph keeps at least one node-phase and one phase-pair term),
    and dyadic prefactors near 1: the probe's rungs, and test data for the
    kernels."""
    rng = np.random.default_rng(seed)
    t1, t2, t3, t4 = terms
    G, P = num_graphs, n_params

    def bits(t):
        return rng.integers(0, 2, size=(t, G, P), dtype=np.uint8)

    def counts(t):
        return rng.integers(min(t, 1), t + 1, size=G).astype(np.int32)

    def ints(high, t):
        return rng.integers(0, high, size=(t, G)).astype(np.int32)

    floatfactor = np.zeros((G, 4), np.int32)
    floatfactor[:, 0] = rng.integers(1, 3, size=G)
    floatfactor[:, 1] = rng.integers(-1, 2, size=G)
    return CompiledScalarGraphs(
        num_graphs=G,
        n_params=P,
        node_phases=NodePhases(phases=ints(8, t1), params=bits(t1), counts=counts(t1)),
        halfpi_phases=HalfPiPhases(coeffs=2 * ints(4, t2), params=bits(t2)),
        pi_products=PiProducts(
            psi_const=ints(2, t3), psi_params=bits(t3), phi_const=ints(2, t3), phi_params=bits(t3)
        ),
        phase_pairs=PhasePairs(
            alpha=ints(8, t4), alpha_params=bits(t4), beta=ints(8, t4), beta_params=bits(t4),
            counts=counts(t4),
        ),
        prefactor=ScalarPrefactor(
            phase_indices=rng.integers(0, 8, size=G).astype(np.int32),
            floatfactor=floatfactor,
            power2=rng.integers(-2, 3, size=G).astype(np.int32),
            approximate_floatfactors=np.tile(np.float32([1.0, 0.0]), (G, 1)),
        ),
    )


def probe_rungs() -> dict:
    """The self-test's seeded rungs, {"wide": rung, "small": rung}, every
    family live (tsim_tpu's probe has node phases only and zero tables)."""
    return {
        name: synthetic_rung(seed, graphs, PROBE_PARAMS, PROBE_TERMS)
        for seed, (name, graphs) in enumerate(PROBE_GRAPHS.items())
    }


def probe_inputs(device) -> tuple[dict, torch.Tensor]:
    """The self-test's inputs on ``device``: ({"wide": tables, "small":
    tables} of :func:`probe_rungs`, (PROBE_ROWS, PROBE_PARAMS) uint8 rows)."""
    tables = {name: SampleTables(rung).to(device) for name, rung in probe_rungs().items()}
    rows = np.random.default_rng(7).integers(0, 2, size=(PROBE_ROWS, PROBE_PARAMS), dtype=np.uint8)
    return tables, torch.from_numpy(rows).to(device)


def self_test(device) -> dict:
    """Launch every f32 configuration at the probe's shape, each dispatched
    as a user's launch of PROBE_ROWS rows is ("wide" takes its 32-shot
    block), and hold it against the plain version; return {configuration:
    max error relative to the row's mass}. Raises RuntimeError naming the
    first configuration that disagrees; nothing switches configuration."""
    tables, rows = probe_inputs(device)
    errors = {}
    for config in _kernel.CONFIGURATIONS:
        t = tables[config.removeprefix("per_term_")]
        got = _kernel.launch(t, rows, config, count_as="self_test")
        want, mass = sample_product_sum_reference(t, rows, with_mass=True)
        scale = mass[:, None]
        err = (got - want).abs()
        errors[config] = float((err / scale.clamp_min(1e-30)).max())
        if not (torch.isfinite(got).all() and (err <= PROBE_ATOL + PROBE_RTOL * scale).all()):
            raise RuntimeError(
                f"sampling kernel self-test: configuration {config!r} disagrees with the plain "
                f"version on {device} (max relative error {errors[config]:.3e}, "
                f"tolerance {PROBE_RTOL})"
            )
    return errors


def ensure_self_test(device) -> None:
    """Run the self-test once per device and process ("cuda" and the card it
    names are one device); re-raise its failure."""
    key = str(indexed_device(device))
    if key not in _self_tested:
        try:
            self_test(device)
            _self_tested[key] = None
        except RuntimeError as exc:
            _self_tested[key] = str(exc)
    if _self_tested[key] is not None:
        raise RuntimeError(_self_tested[key])


def reset_self_test() -> None:
    """Forget every device's self-test, so the next f32 launch runs it again."""
    _self_tested.clear()
