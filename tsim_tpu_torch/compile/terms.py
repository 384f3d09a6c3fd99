"""Exact evaluation of the four term families (counterpart of ``tsim_tpu/compile/terms.py``).

Each compiled scalar graph is a product of four families and a static
prefactor. Each function below takes one family, a ``program_io``
dataclass whose leaves are numpy arrays or tensors, and a batch of (B, P)
0/1 parameter rows, and returns the family's value per (row, graph) as an
:class:`ExactScalarArray` of shape (B, G).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.exact_scalar import ExactScalarArray
from ..ops.gf2 import matmul_gf2

# UNIT_PHASES[k] = exact coefficients of w^k in the (1, w, w^2, w^3) basis.
UNIT_PHASES = np.array(
    [
        [1, 0, 0, 0],
        [0, 1, 0, 0],
        [0, 0, 1, 0],
        [0, 0, 0, 1],
        [-1, 0, 0, 0],
        [0, -1, 0, 0],
        [0, 0, -1, 0],
        [0, 0, 0, -1],
    ],
    dtype=np.int32,
)


def leaf(a, device, dtype=torch.int32) -> torch.Tensor:
    """A program leaf (numpy array or tensor) as a tensor on ``device``."""
    return torch.as_tensor(a, device=device).to(dtype)


def _identity(batch: int, num_graphs: int, device) -> ExactScalarArray:
    c = torch.zeros((4, batch, num_graphs), dtype=torch.int32, device=device)
    c[0] = 1
    return ExactScalarArray.from_coeffs(c)


def omega_coeffs(k: torch.Tensor) -> torch.Tensor:
    """Exact (4, ...) coefficients of w^k: ``(-1)^(k // 4)`` at position ``k % 4``."""
    k = k.to(torch.int32)
    sign = 1 - 2 * (torch.div(k, 4, rounding_mode="floor") & 1)
    km = k & 3
    zero = torch.zeros_like(k)
    return torch.stack([torch.where(km == j, sign, zero) for j in range(4)])


def one_plus_omega_coeffs(k: torch.Tensor) -> torch.Tensor:
    """Exact (4, ...) coefficients of 1 + w^k."""
    c = omega_coeffs(k)
    c[0] += 1
    return c


def _mask_terms(term_vals: torch.Tensor, counts, device) -> torch.Tensor:
    """Replace term slots at or past each graph's count by the identity 1."""
    t = term_vals.shape[2]
    live = torch.arange(t, device=device)[:, None] < leaf(counts, device)[None, :]  # (T, G)
    ident = torch.zeros_like(term_vals)
    ident[0] = 1
    return torch.where(live[None, None], term_vals, ident)


def evaluate_node_phases(fam, x: torch.Tensor) -> ExactScalarArray:
    """Product over live terms of ``1 + w^(phase + 4 parity)``."""
    t, g = np.shape(fam.phases)
    if t == 0:
        return _identity(x.shape[0], g, x.device)
    rowsum = matmul_gf2(leaf(fam.params, x.device, torch.uint8), x).to(torch.int32)  # (B, T, G)
    phase_idx = (4 * rowsum + leaf(fam.phases, x.device)) & 7
    term_vals = _mask_terms(one_plus_omega_coeffs(phase_idx), fam.counts, x.device)
    return ExactScalarArray.from_coeffs(term_vals).prod(axis=1)


def evaluate_halfpi_phases(fam, x: torch.Tensor) -> ExactScalarArray:
    """``w^(sum coeff * parity mod 8)``, coefficients in eighth turns."""
    t, g = np.shape(fam.coeffs)
    if t == 0:
        return _identity(x.shape[0], g, x.device)
    rowsum = matmul_gf2(leaf(fam.params, x.device, torch.uint8), x).to(torch.int32)
    phase_idx = (rowsum * leaf(fam.coeffs, x.device)) & 7
    total = phase_idx.sum(dim=1, dtype=torch.int32) & 7
    return ExactScalarArray.from_coeffs(omega_coeffs(total))


def evaluate_pi_products(fam, x: torch.Tensor) -> ExactScalarArray:
    """``(-1)^(sum psi * phi)``, each side a constant XOR a parity."""
    t, g = np.shape(fam.psi_const)
    if t == 0:
        return _identity(x.shape[0], g, x.device)
    dev = x.device
    psi = (leaf(fam.psi_const, dev) + matmul_gf2(leaf(fam.psi_params, dev, torch.uint8), x)) & 1
    phi = (leaf(fam.phi_const, dev) + matmul_gf2(leaf(fam.phi_params, dev, torch.uint8), x)) & 1
    exponent = (psi * phi).sum(dim=1, dtype=torch.int32) & 1  # (B, G)
    coeffs = torch.zeros((4,) + exponent.shape, dtype=torch.int32, device=dev)
    coeffs[0] = 1 - 2 * exponent
    return ExactScalarArray.from_coeffs(coeffs)


def evaluate_phase_pairs(fam, x: torch.Tensor) -> ExactScalarArray:
    """Product over live terms of ``1 + w^a + w^b - w^(a+b)``."""
    ra = matmul_gf2(leaf(fam.alpha_params, x.device, torch.uint8), x)
    rb = matmul_gf2(leaf(fam.beta_params, x.device, torch.uint8), x)
    return phase_pair_product(fam, ra, rb)


def phase_pair_product(fam, ra: torch.Tensor, rb: torch.Tensor) -> ExactScalarArray:
    """:func:`evaluate_phase_pairs` from the terms' alpha and beta parities,
    each (B, T, G)."""
    t, g = np.shape(fam.alpha)
    dev = ra.device
    if t == 0:
        return _identity(ra.shape[0], g, dev)
    a = (leaf(fam.alpha, dev) + 4 * ra.to(torch.int32)) & 7
    b = (leaf(fam.beta, dev) + 4 * rb.to(torch.int32)) & 7
    term_vals = omega_coeffs(a) + omega_coeffs(b) - omega_coeffs((a + b) & 7)
    term_vals[0] += 1
    term_vals = _mask_terms(term_vals, fam.counts, dev)
    return ExactScalarArray.from_coeffs(term_vals).prod(axis=1)
