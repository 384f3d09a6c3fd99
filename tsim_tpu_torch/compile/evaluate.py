"""Exact evaluation of compiled scalar graphs (counterpart of ``tsim_tpu/compile/evaluate.py``).

This is the plain PyTorch version of the exact kernels
(``kernels/csrc/exact_eval.cu``). Per row and per graph it forms the
exact Z[w] * 2^p product of the four families and the static prefactor,
then either

* sums over graphs exactly (a rung without approximate floatfactors) and
  converts once to float32, or
* converts each graph's product to float32 (re, im) * 2^p, multiplies it
  by the graph's approximate complex factor and sums in float32.

It runs in row chunks: unchunked, the (4, B, T, G) int32 term arrays of a
wide rung at 2^20 rows would need tens of GB.
"""

from __future__ import annotations

import functools
import operator

import numpy as np
import torch

from ..core.exact_scalar import ExactScalarArray, coeffs_to_real_imag, exact_magnitude, exp2_int
from .terms import (
    evaluate_halfpi_phases,
    evaluate_node_phases,
    evaluate_phase_pairs,
    evaluate_pi_products,
    leaf,
    omega_coeffs,
)

# Bytes of one chunk's largest int32 term array, (4, rows, T, G); a few
# such arrays are alive at once.
CHUNK_BYTES = 1 << 28


def _evaluate_parts(circuit, x: torch.Tensor) -> ExactScalarArray:
    """Exact product of the four families, ``w^phase`` and the floatfactor: (B, G)."""
    pf = circuit.prefactor
    dev = x.device
    static_phases = ExactScalarArray.from_coeffs(omega_coeffs(leaf(pf.phase_indices, dev)))
    float_factor = ExactScalarArray.from_coeffs_last(leaf(pf.floatfactor, dev))
    return functools.reduce(
        operator.mul,
        [
            evaluate_node_phases(circuit.node_phases, x),
            evaluate_halfpi_phases(circuit.halfpi_phases, x),
            evaluate_pi_products(circuit.pi_products, x),
            evaluate_phase_pairs(circuit.phase_pairs, x),
            static_phases,
            float_factor,
        ],
    )


def _approx_parts(circuit, total: ExactScalarArray):
    """Per-graph float32 (re, im) of the exact product times 2^power2 and the
    approximate factor."""
    pf = circuit.prefactor
    dev = total.coeffs.device
    re, im = coeffs_to_real_imag(total.coeffs)
    scale = exp2_int(total.power + leaf(pf.power2, dev))
    approx = leaf(pf.approximate_floatfactors, dev, torch.float32)
    fre, fim = approx[:, 0] * scale, approx[:, 1] * scale
    return re * fre - im * fim, re * fim + im * fre


def chunk_rows(circuit) -> int:
    """Rows per chunk, so that one (4, rows, T, G) int32 array stays under CHUNK_BYTES."""
    t = max(
        np.shape(circuit.node_phases.phases)[0],
        np.shape(circuit.halfpi_phases.coeffs)[0],
        np.shape(circuit.pi_products.psi_const)[0],
        np.shape(circuit.phase_pairs.alpha)[0],
        1,
    )
    return max(1, CHUNK_BYTES // (16 * t * max(int(circuit.num_graphs), 1)))


def plain_bytes_per_row(dims, n_params: int, num_graphs: int) -> int:
    """Bytes a row that :func:`evaluate_abs` holds at its peak on the rows of
    one chunk (a batch of more rows than a chunk holds less a row), its
    result included, for a rung of ``dims`` = (T1, T2, T3, T4) term slots.
    The families are evaluated one after the other, and the one that holds
    the most sets the peak: a (term, graph) slot takes 64 bytes for a node
    phase (four (4,) int32 Z[w] arrays: its w^k, their stack, the identity,
    the masked copy), 80 for a phase pair (three w^k, their sum, the masked
    copy), 32 for a half-pi phase and 24 for a pi product (int32 parities
    and their products). Beside it, 160 bytes a graph (the six factors of
    :func:`_evaluate_parts` as Z[w] with their power, their running product,
    the graph sum's first tree level) and the rows as float32."""
    t1, t2, t3, t4 = dims
    return 4 * n_params + (max(64 * t1, 32 * t2, 24 * t3, 80 * t4) + 160) * max(num_graphs, 1)


def exact_sum(circuit, x: torch.Tensor) -> ExactScalarArray:
    """The exact graph sum per row, (4, B) coefficients and (B,) power.

    For rungs without approximate floatfactors.
    """
    total = _evaluate_parts(circuit, x)
    power = total.power + leaf(circuit.prefactor.power2, x.device)
    return ExactScalarArray(coeffs=total.coeffs, power=power).sum()


def _rows_in_chunks(circuit, x: torch.Tensor, fn) -> torch.Tensor:
    step = chunk_rows(circuit)
    return torch.cat([fn(x[i : i + step]) for i in range(0, x.shape[0], step)])


def evaluate_abs(circuit, x: torch.Tensor) -> torch.Tensor:
    """|amplitude| per row: (B, P) uint8 -> (B,) float32."""
    batch = x.shape[0]
    if int(circuit.num_graphs) == 0 or batch == 0:
        return torch.zeros(batch, dtype=torch.float32, device=x.device)

    def chunk(xs):
        if not circuit.prefactor.has_approximate_floatfactors:
            s = exact_sum(circuit, xs)
            return exact_magnitude(s.coeffs, s.power)
        re, im = _approx_parts(circuit, _evaluate_parts(circuit, xs))
        out_re, out_im = re.sum(dim=-1), im.sum(dim=-1)
        return torch.sqrt(out_re * out_re + out_im * out_im)

    return _rows_in_chunks(circuit, x, chunk)


def evaluate(circuit, x: torch.Tensor) -> torch.Tensor:
    """Complex amplitudes per row: (B, P) uint8 -> (B,) complex64."""
    batch = x.shape[0]
    if int(circuit.num_graphs) == 0 or batch == 0:
        return torch.zeros(batch, dtype=torch.complex64, device=x.device)

    def chunk(xs):
        if not circuit.prefactor.has_approximate_floatfactors:
            re, im = exact_sum(circuit, xs).to_real_imag()
            return torch.complex(re, im)
        re, im = _approx_parts(circuit, _evaluate_parts(circuit, xs))
        return torch.complex(re.sum(dim=-1), im.sum(dim=-1))

    return _rows_in_chunks(circuit, x, chunk)
