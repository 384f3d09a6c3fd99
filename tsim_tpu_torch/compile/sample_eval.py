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
"""

from __future__ import annotations

import torch

from ..kernels import sample_eval as _kernel
from .exact_eval import evaluate_abs_exact
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


def rung_tables(circuit, evaluation: str = "f32") -> SampleTables | ExactTables:
    """The evaluator tables of one rung: exact in exact mode or when the rung
    fails ``sample_eligible``, f32 otherwise."""
    if check_evaluation(evaluation) == "exact" or not sample_eligible(circuit):
        return ExactTables(circuit)
    return SampleTables(circuit)


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


def sample_product_sum_reference(tables: SampleTables, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the sampling kernel: (B, P) uint8 -> (B, 2) f32.

    Follows ``_product_body_sample_packed`` with the graph axis summed.
    Parities are a float32 matmul mod 2 (row sums are at most P, exact in
    f32), because CUDA tensors have no integer matmul.
    """
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
    return torch.stack(
        [(re * pr - im * pi_).sum(dim=1), (re * pi_ + im * pr).sum(dim=1)], dim=1
    )


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
    """|amplitude| per row: plain version on the CPU, CUDA kernel otherwise."""
    _check_input(tables, x)
    if x.device.type == "cpu":
        total = sample_product_sum_reference(tables, x)
    else:
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
