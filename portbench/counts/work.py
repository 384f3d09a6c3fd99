"""Least work of the program's kernels, counted from a rung's compiled
shapes whatever kernel runs it, and the peaks of one H100 SXM.

``live_terms``, ``parity_bits``, ``f32_bound``, ``exact_bound``,
``approx_operations``, ``approx_bound`` and the three peaks are copied from
the repository's ``chip_smoke.py``, docstrings included; ``noise_bound``
adds the noise draw's count. A rung (``circuit``) is one entry of a
component's ``compiled_scalar_graphs``, ``tables`` its exact tables; each
bound returns (least milliseconds, what bounds it).

The int32 peak is derived, not a data-sheet figure: 132 SMs, 64 int32
results a clock an SM (the CUDA programming guide's throughput table for
compute capability 9.0) and the boost clock of 1.98 GHz. The other two are
NVIDIA's published H100 SXM figures (HBM3 at 3.35 TB/s; f32 at 67 TFLOP/s
outside the tensor cores), which assume the card's full 700 W; the
benchmark prints the card's power limit beside every share.
"""

from __future__ import annotations

import numpy as np

# Peaks of one H100 SXM (NVIDIA's data sheet; 132 SMs at a boost clock of
# 1.98 GHz): HBM at 3.35 TB/s; f32 at 67 TFLOP/s outside the tensor cores
# (128 lanes an SM, an FMA counted as two); int32 adds, multiplies and
# logic at 64 results per clock an SM (the CUDA programming guide's
# throughput table for compute capability 9.0), so 132 * 64 * 1.98e9 =
# 16.7e12 a second.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def live_terms(circuit) -> tuple[int, int, int, int]:
    """Live terms summed over the graphs, per family: node phases and phase
    pairs by their counts, half-pi phases with a nonzero coefficient, pi
    products whose two sides are not both zero."""
    n1 = int(np.sum(circuit.node_phases.counts))
    n2 = int(np.count_nonzero(np.asarray(circuit.halfpi_phases.coeffs) & 7))
    pp = circuit.pi_products
    psi = (np.asarray(pp.psi_const) & 1).astype(bool) | np.asarray(pp.psi_params).any(axis=-1)
    phi = (np.asarray(pp.phi_const) & 1).astype(bool) | np.asarray(pp.phi_params).any(axis=-1)
    n3 = int(np.count_nonzero(psi & phi))
    n4 = int(np.sum(circuit.phase_pairs.counts))
    return n1, n2, n3, n4


def parity_bits(circuit) -> int:
    """Parameters set in the live parity rows, summed over the graphs: with
    32 shots' bits of one parameter in a word, each costs one XOR per 32
    shots, the least parity work of any of the kernels."""
    npp, hp, pp, qp = circuit.node_phases, circuit.halfpi_phases, circuit.pi_products, circuit.phase_pairs

    def under(counts, params):
        t = np.asarray(params).shape[0]
        return (np.arange(t)[:, None] < np.asarray(counts)[None, :])[..., None]

    live_pp = (np.asarray(pp.psi_params).any(axis=-1) | (np.asarray(pp.psi_const) & 1).astype(bool)) & (
        np.asarray(pp.phi_params).any(axis=-1) | (np.asarray(pp.phi_const) & 1).astype(bool)
    )
    return int(
        (np.asarray(npp.params) * under(npp.counts, npp.params)).sum()
        + np.asarray(hp.params)[(np.asarray(hp.coeffs) & 7) != 0].sum()
        + np.asarray(pp.psi_params)[live_pp].sum() + np.asarray(pp.phi_params)[live_pp].sum()
        + (np.asarray(qp.alpha_params) * under(qp.counts, qp.alpha_params)).sum()
        + (np.asarray(qp.beta_params) * under(qp.counts, qp.beta_params)).sum()
    )


def _bound(t_ops: float, t_bytes: float) -> tuple[float, str]:
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def f32_bound(circuit, table_bytes: int, rows: int) -> tuple[float, str]:
    """(least ms, what bounds it) of one f32 evaluation (K1-K4, K8) of
    ``rows`` rows: the larger of its bytes (rows once, tables once, (re, im)
    out once) over HBM and its f32 operations over the f32 peak. The least
    f32 operations per row: 6 per live node-phase and phase-pair term (a
    complex product by a factor chosen by the term's parities from
    constants), 12 per graph (the half-pi rotation, the prefactor's complex
    product, the graph sum). The integer parity work runs beside it on
    other units and is not counted."""
    n1, _, _, n4 = live_terms(circuit)
    flops = rows * (6 * (n1 + n4) + 12 * circuit.num_graphs)
    nbytes = rows * circuit.n_params + table_bytes + rows * 8
    return _bound(flops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def exact_bound(circuit, tables, rows: int) -> tuple[float, str]:
    """(least ms, what bounds it) of one exact evaluation (K5-K7b) of
    ``rows`` rows of the rung ``circuit`` held by ``tables``: the larger of
    its bytes (rows, tables and the result once: Z[w] coefficients and
    power, or (re, im)) over HBM and its int32 operations over the int32
    peak. The least int32 operations per row: the parities bit-sliced
    (:func:`parity_bits` / 32), 4 adds per live node-phase term (acc +
    w^k acc), 12 per live phase-pair term (three rotated copies of acc
    added), and with the exact finisher 32 per graph (the prefactor's Z[w]
    product, the graph sum); the approximate finisher's float work per
    graph is not counted."""
    n1, _, _, n4 = live_terms(circuit)
    per_graph = 0 if tables.approximate else 32
    ops = rows * (4 * n1 + 12 * n4 + per_graph * circuit.num_graphs + parity_bits(circuit) / 32)
    out = 8 if tables.approximate else 20
    nbytes = rows * tables.n_params + 4 * (tables.flat.numel() + tables.approx.numel()) + rows * out
    return _bound(ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def approx_operations(circuit) -> float:
    """Least int32 operations per row of the approximate finisher (K6, K7b),
    counted family by family as the cheapest known way forms the float32
    value, whatever the kernel does:

    * the parities bit-sliced, one XOR per set parameter per 32 rows
      (:func:`parity_bits` / 32);
    * a live node-phase term of phase 0 or 4 has the factor 2 or 0, chosen by
      its parity alone: one OR into the graph's zero plane per 32 rows;
    * a live half-pi term and a live pi product fold into bit planes too (a
      ripple into the total, an AND into the sign): 1/32 each;
    * a live node-phase term of any other phase needs its own value per row
      (a counter's increment chosen by the parity): one operation;
    * a live phase-pair term is not a monomial and stays a Z[w] product: 12,
      as :func:`exact_bound` counts it.

    The float work of the one conversion per graph is not counted."""
    npp = circuit.node_phases
    phases = np.asarray(npp.phases) & 7
    live = np.arange(phases.shape[0])[:, None] < np.asarray(npp.counts)[None, :]
    sliced = int(np.count_nonzero(live & (phases & 3 == 0)))
    n1, n2, n3, n4 = live_terms(circuit)
    return (n1 - sliced) + 12 * n4 + (sliced + n2 + n3 + parity_bits(circuit)) / 32


def approx_bound(circuit, tables, rows: int) -> tuple[float, str]:
    """(least ms, what bounds it) of one evaluation with the approximate
    finisher (K6, K7b): its bytes (rows, the table buffer and the (re, im)
    result once; the approximate factors lie folded inside the buffer) over
    HBM, and :func:`approx_operations` per row over the int32 peak.
    :func:`exact_bound` charges a node-phase term the 4 adds of ``acc + w^k
    acc``, which a product kept as counters does not need, so that count is
    kept for the exact finisher only."""
    ops = rows * approx_operations(circuit)
    nbytes = rows * tables.n_params + 4 * tables.flat.numel() + rows * 8
    return _bound(ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def noise_bound(num_channels: int, num_f: int, table_bytes: int, rows: int) -> tuple[float, str]:
    """(least ms, what bounds it) of one noise draw of ``rows`` rows: each
    row's C float32 uniforms read and its F uint8 noise bits written once,
    and the draw table read once, over HBM ((4C + F) bytes a row, as
    ``chip_smoke.py`` phase 26 counts it). Its arithmetic is not counted."""
    return _bound(0.0, ((4 * num_channels + num_f) * rows + table_bytes) / HBM_BYTES_PER_S)
