"""The f32 sampling evaluator: plain PyTorch version and dispatch.

Counterpart of the dispatch half of ``tsim_tpu``'s
``compile/pallas_sample.py`` (``evaluate_abs_sample_f32``,
``evaluate_abs_sample``, ``norm_deviation_tolerance``). Per shot row and
per graph it forms the complex f32 product of the four term families
times the prefolded prefactor, sums over graphs, and returns the
magnitude rescaled by ``2^bias``.

A CPU tensor runs the plain version below; a CUDA tensor runs the
hand-written kernel (``kernels/sample_eval.py``), which raises if it
cannot be built or launched.
"""

from __future__ import annotations

import torch

from ..kernels import sample_eval as _kernel
from .sample_tables import _SQRT_HALF, SampleTables, unpack_words


def norm_deviation_tolerance() -> float:
    """Warn threshold of the sampler's normalization monitor.

    The port evaluates every rung in f32 (the exact path is not ported
    yet), so this is ``tsim_tpu``'s f32 band: products accumulate about
    ``T * 2^-23`` relative error plus cancellation in the graph sum.
    """
    return 3e-3


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


def evaluate_abs_sample(tables: SampleTables, x: torch.Tensor) -> torch.Tensor:
    """Sampling-mode evaluation of one rung: (B, P) uint8 -> (B,) float32."""
    if tables.num_graphs == 0:
        return torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    if not tables.eligible:
        raise NotImplementedError(
            "this rung fails sample_eligible (its products exceed the f32 range); "
            "tsim_tpu evaluates it through the exact kernels "
            "(compile/pallas_evaluate.py::evaluate_abs_auto), which are not ported yet"
        )
    return evaluate_abs_sample_f32(tables, x)
