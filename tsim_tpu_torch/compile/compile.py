"""Compilation of scalar ZX graphs into static-shaped numpy arrays.

Extracts the five symbolic term families from each graph's scalar into
padded arrays (semantics of reference ``tsim/compile/compile.py``), working
from our own :class:`tsim_tpu_torch.zx.scalar.Scalar`. The arrays are
written straight into ``program_io``'s dataclasses, with the dtypes and
layouts ``tsim_tpu`` gives them.
"""

from __future__ import annotations

from dataclasses import replace
from fractions import Fraction
from functools import lru_cache
from math import isqrt

import numpy as np

from ..program_io import (
    CompiledScalarGraphs,
    HalfPiPhases,
    NodePhases,
    PhasePairs,
    PiProducts,
    ScalarPrefactor,
)
from ..zx.graph import ZXGraph


def _bitvec(varset, char_to_idx, n_params):
    out = np.zeros(n_params, dtype=np.uint8)
    for v in varset:
        if v == "1":
            continue
        out[char_to_idx[v]] = 1
    return out


def _compile_node_phases(g_list, char_to_idx, n_params) -> NodePhases:
    terms = []
    for g in g_list:
        s = g.scalar
        rows = []
        for ph, varset in zip(s.phasenodes, s.phasenodevars):
            assert Fraction(ph).denominator in (1, 2, 4), ph
            rows.append((int(Fraction(ph) * 4) % 8, _bitvec(varset, char_to_idx, n_params)))
        terms.append(rows)
    counts = np.array([len(t) for t in terms], dtype=np.int32)
    max_t = int(counts.max()) if counts.size else 0
    phases = np.zeros((len(g_list), max_t), dtype=np.uint8)
    params = np.zeros((len(g_list), max_t, n_params), dtype=np.uint8)
    for i, rows in enumerate(terms):
        for j, (c, bits) in enumerate(rows):
            phases[i, j] = c
            params[i, j] = bits
    # (T, G) layout, graph axis trailing, as tsim_tpu lays it out.
    return NodePhases(
        phases=np.ascontiguousarray(phases.T),
        params=np.ascontiguousarray(params.transpose(1, 0, 2)),
        counts=counts,
    )


def _compile_halfpi_phases(g_list, char_to_idx, n_params) -> HalfPiPhases:
    terms = []
    for g in g_list:
        s = g.scalar
        assert set(s.phasevars_halfpi.keys()) <= {1, 3}
        bitstr_to_j: dict[tuple, int] = {}
        for j in (1, 3):
            for varset in s.phasevars_halfpi.get(j, []):
                key = tuple(_bitvec(varset, char_to_idx, n_params))
                bitstr_to_j[key] = (bitstr_to_j.get(key, 0) + j) % 4
        rows = [
            (2 * jv, np.array(key, dtype=np.uint8))
            for key, jv in bitstr_to_j.items()
            if jv != 0
        ]
        terms.append(rows)
    max_t = max((len(t) for t in terms), default=0)
    coeffs = np.zeros((len(g_list), max_t), dtype=np.uint8)
    params = np.zeros((len(g_list), max_t, n_params), dtype=np.uint8)
    for i, rows in enumerate(terms):
        for j, (c, bits) in enumerate(rows):
            coeffs[i, j] = c
            params[i, j] = bits
    return HalfPiPhases(
        coeffs=np.ascontiguousarray(coeffs.T),
        params=np.ascontiguousarray(params.transpose(1, 0, 2)),
    )


def _compile_pi_products(g_list, char_to_idx, n_params) -> PiProducts:
    terms = []
    for g in g_list:
        rows = []
        for psi, phi in g.scalar.phasevars_pi_pair:
            rows.append(
                (
                    1 if "1" in psi else 0,
                    _bitvec(psi, char_to_idx, n_params),
                    1 if "1" in phi else 0,
                    _bitvec(phi, char_to_idx, n_params),
                )
            )
        terms.append(rows)
    max_t = max((len(t) for t in terms), default=0)
    G = len(g_list)
    psi_c = np.zeros((G, max_t), dtype=np.uint8)
    psi_p = np.zeros((G, max_t, n_params), dtype=np.uint8)
    phi_c = np.zeros((G, max_t), dtype=np.uint8)
    phi_p = np.zeros((G, max_t, n_params), dtype=np.uint8)
    for i, rows in enumerate(terms):
        for j, (pc, pp, fc, fp) in enumerate(rows):
            psi_c[i, j] = pc
            psi_p[i, j] = pp
            phi_c[i, j] = fc
            phi_p[i, j] = fp
    return PiProducts(
        psi_const=np.ascontiguousarray(psi_c.T),
        psi_params=np.ascontiguousarray(psi_p.transpose(1, 0, 2)),
        phi_const=np.ascontiguousarray(phi_c.T),
        phi_params=np.ascontiguousarray(phi_p.transpose(1, 0, 2)),
    )


def _compile_phase_pairs(g_list, char_to_idx, n_params) -> PhasePairs:
    terms = []
    for g in g_list:
        rows = []
        for pp in g.scalar.phasepairs:
            rows.append(
                (
                    int(pp.alpha) % 8,
                    int(pp.beta) % 8,
                    _bitvec(pp.paramsA, char_to_idx, n_params),
                    _bitvec(pp.paramsB, char_to_idx, n_params),
                )
            )
        terms.append(rows)
    counts = np.array([len(t) for t in terms], dtype=np.int32)
    max_t = int(counts.max()) if counts.size else 0
    G = len(g_list)
    alpha = np.zeros((G, max_t), dtype=np.uint8)
    beta = np.zeros((G, max_t), dtype=np.uint8)
    ap = np.zeros((G, max_t, n_params), dtype=np.uint8)
    bp = np.zeros((G, max_t, n_params), dtype=np.uint8)
    for i, rows in enumerate(terms):
        for j, (a, b_, pa, pb) in enumerate(rows):
            alpha[i, j] = a
            beta[i, j] = b_
            ap[i, j] = pa
            bp[i, j] = pb
    return PhasePairs(
        alpha=np.ascontiguousarray(alpha.T),
        alpha_params=np.ascontiguousarray(ap.transpose(1, 0, 2)),
        beta=np.ascontiguousarray(beta.T),
        beta_params=np.ascontiguousarray(bp.transpose(1, 0, 2)),
        counts=counts,
    )


def _compile_prefactor(g_list) -> ScalarPrefactor:
    approx = []
    phase_idx = []
    floatfactor = []
    power2 = []
    for g in g_list:
        s = g.scalar
        a = complex(s.approximate_floatfactor)
        ph = s.phase
        if ph.denominator not in (1, 2, 4):
            a *= complex(np.exp(1j * np.pi * float(ph)))
            ph = Fraction(0)
        approx.append(a)
        phase_idx.append(int(ph * 4) % 8)
        ff = s.floatfactor
        floatfactor.append([ff.a, ff.b, ff.c, ff.d])
        p2 = s.power2
        if p2 % 2 != 0:
            # absorb one sqrt(2) = w + w^3 (in (1, w, i, w^3) basis: w - w^3
            # is i*sqrt(2)... sqrt(2) = w + conj(w) = w - i*w = coefficient
            # vector (0, 1, 0, -1) since w^3 = i*w and conj(w) = -w^3.
            p2 -= 1
            from ..zx.scalar import ExactDyadic

            d = ExactDyadic(floatfactor[-1][0], floatfactor[-1][1],
                            floatfactor[-1][2], floatfactor[-1][3]) * ExactDyadic(0, 1, 0, -1)
            floatfactor[-1] = [d.a, d.b, d.c, d.d]
        power2.append(p2 // 2)
    has_approx = any(abs(a - 1.0) > 1e-12 for a in approx)
    # Complex stored as float32 (G, 2) pairs, as tsim_tpu stores it.
    approx_ri = np.array([[a.real, a.imag] for a in approx], dtype=np.float32)
    return ScalarPrefactor(
        phase_indices=np.array(phase_idx, dtype=np.uint8),
        floatfactor=np.array(floatfactor, dtype=np.int32).reshape(-1, 4),
        power2=np.array(power2, dtype=np.int32),
        approximate_floatfactors=approx_ri.reshape(-1, 2),
        has_approximate_floatfactors=has_approx,
    )


# The exact evaluator and kernels hold Z[w] coefficients in int32.
INT32_LIMIT = 1 << 31
# Fractional bits of the integer upper bounds below.
_BOUND_BITS = 64


def _norm_squared(c) -> tuple[int, int]:
    """(A, B) with max_j |sigma_j(x)|^2 = A + B sqrt(2), B >= 0, for x =
    c0 + c1 w + c2 w^2 + c3 w^3 in Z[w], exactly.

    The four embeddings sigma_j: w -> w^j (j odd) of Z[w] into C send
    x conj(x) = A + B' sqrt(2) (its w^2 coefficient is 0, its w and w^3
    ones opposite) to A + B' sqrt(2) or A - B' sqrt(2)."""
    c0, c1, c2, c3 = (int(v) for v in c)
    a = c0 * c0 + c1 * c1 + c2 * c2 + c3 * c3
    b = c0 * c1 + c1 * c2 + c2 * c3 - c3 * c0
    return a, abs(b)


def _ge(x: tuple[int, int], y: tuple[int, int]) -> bool:
    """x >= y for a + b sqrt(2) with integers, exactly."""
    da, db = x[0] - y[0], x[1] - y[1]
    if da >= 0 and db >= 0:
        return True
    if da <= 0 and db <= 0:
        return da == 0 and db == 0
    return (da * da > 2 * db * db) if da > 0 else (2 * db * db > da * da)


def _term_squares(values) -> tuple[int, int]:
    """The largest of the squared embeddings of the Z[w] ``values`` (one
    per parity), and at least 1."""
    out = (1, 0)
    for c in values:
        v = _norm_squared(c)
        if _ge(v, out):
            out = v
    return out


def _w(k: int) -> list[int]:
    c = [0, 0, 0, 0]
    c[k % 4] = -1 if (k % 8) >= 4 else 1
    return c


@lru_cache(maxsize=None)
def _node_square(phase: int) -> tuple[int, int]:
    """Squared bound of ``1 + w^(phase + 4 parity)`` over parities and embeddings."""
    return _term_squares([np.add([1, 0, 0, 0], _w(phase + 4 * p)) for p in range(2)])


@lru_cache(maxsize=None)
def _pair_square(alpha: int, beta: int) -> tuple[int, int]:
    """The same for ``1 + w^a + w^b - w^(a+b)``, a = alpha + 4 parity, b = beta + 4 parity."""
    values = []
    for pa in range(2):
        for pb in range(2):
            a, b = alpha + 4 * pa, beta + 4 * pb
            values.append(np.array([1, 0, 0, 0]) + _w(a) + _w(b) - _w(a + b))
    return _term_squares(values)


def _times(x: tuple[int, int], y: tuple[int, int]) -> tuple[int, int]:
    return x[0] * y[0] + 2 * x[1] * y[1], x[0] * y[1] + x[1] * y[0]


def _scaled_sqrt_ceil(x: tuple[int, int]) -> int:
    """An integer at least 2^_BOUND_BITS sqrt(A + B sqrt(2)); exact where
    that is an integer, as for a power of two."""
    a, b = x
    k = _BOUND_BITS
    if b == 0:
        r = isqrt(a << (2 * k))
        return r if r * r == a << (2 * k) else r + 1
    sqrt2 = isqrt(2 << (2 * k)) + 1  # >= 2^k sqrt(2)
    n = (a << k) + b * sqrt2  # >= 2^k (A + B sqrt(2))
    return isqrt(n << k) + 1


def coefficient_bound(node: NodePhases, pairs: PhasePairs, prefactor: ScalarPrefactor) -> Fraction:
    """An upper bound on every int32 coefficient the exact evaluation of a
    rung forms, for every row (``compile/evaluate.py``, the exact kernels),
    in exact integer arithmetic.

    A coefficient c_i of x in Z[w] is the mean of sigma_j(x) w^(-ij) over
    the four embeddings, so |c_i| <= max_j |sigma_j(x)|, and sigma_j is
    multiplicative. Per graph g, E_g is max_j |sigma_j(floatfactor_g)| times,
    per live node and phase-pair term, its largest embedding over parities
    (at least 1, so a partial product stays under the whole, as is the
    floatfactor's, its four embeddings multiplying to a nonzero integer's
    norm; the half-pi, pi-product and static phases have modulus 1). A graph's coefficients at
    its own power (at least ``power2_g``: the evaluator only moves factors
    of two out) stay under E_g; the aligned graph sum of an exact rung
    shifts every graph to the smallest power, so every partial sum stays
    under sum_g E_g 2^(power2_g - min power2), the bound of such a rung; an
    approximate rung sums in float32 and is bounded by max_g E_g. The bound
    is computed from each E_g^2 in Z[sqrt 2], rounded up at
    2^-_BOUND_BITS where E_g is not an integer.
    """
    g = len(prefactor.power2)
    if g == 0:
        return Fraction(0)
    squares = [_norm_squared(c) for c in np.asarray(prefactor.floatfactor)]
    for fam, square, keys in (
        (node, _node_square, (node.phases,)),
        (pairs, _pair_square, (pairs.alpha, pairs.beta)),
    ):
        keys = [np.asarray(k, np.int64) for k in keys]
        counts = np.asarray(fam.counts)
        for i in range(g):
            for t in range(int(counts[i])):
                squares[i] = _times(squares[i], square(*(int(k[t, i]) for k in keys)))
    bounds = [_scaled_sqrt_ceil(sq) for sq in squares]
    if prefactor.has_approximate_floatfactors:
        return Fraction(max(bounds), 1 << _BOUND_BITS)
    power2 = [int(p) for p in np.asarray(prefactor.power2)]
    low = min(power2)
    return Fraction(sum(e << (p - low) for e, p in zip(bounds, power2)), 1 << _BOUND_BITS)


def _strip_factors_of_two(prefactor: ScalarPrefactor) -> ScalarPrefactor:
    """The same values with every floatfactor's factors of two moved into ``power2``."""
    ff = np.asarray(prefactor.floatfactor).astype(np.int64)
    power2 = np.asarray(prefactor.power2).astype(np.int64)
    for i in range(len(ff)):
        while ff[i].any() and not (ff[i] & 1).any():
            ff[i] >>= 1
            power2[i] += 1
    return replace(prefactor, floatfactor=ff.astype(np.int32), power2=power2.astype(np.int32))


# Rungs of at most this many parameters whose bound fails are compared row
# by row (2^P rows) with their stripped tables before these replace them.
_ENUMERATED_PARAMS = 14


def _same_on_every_row(a: CompiledScalarGraphs, b: CompiledScalarGraphs) -> bool:
    """Whether the two tables of one rung evaluate equal on all 2^P rows
    (False where P is too large to enumerate)."""
    import torch

    from .evaluate import evaluate_abs

    if a.n_params > _ENUMERATED_PARAMS:
        return False
    rows = (np.arange(1 << a.n_params)[:, None] >> np.arange(a.n_params)[None]) & 1
    x = torch.from_numpy(rows.astype(np.uint8))
    return bool(torch.equal(evaluate_abs(a, x), evaluate_abs(b, x)))


def compile_scalar_graphs(g_list: list[ZXGraph], params: list[str]) -> CompiledScalarGraphs:
    """Compile vertex-free graphs into static-shaped arrays for evaluation.

    The decomposition carries constant factors of two in a graph's
    floatfactor (up to 2^30 on noisy grown cultivation, where ``power2``
    holds the opposite), and the exact evaluation sums graphs aligned to
    the smallest power in int32, where they overflowed. Where
    :func:`coefficient_bound` exceeds 2^31, the factors of two move into
    ``power2``. A bound of exactly 2^31 is kept (2-check cultivation's rung
    8, 32 graphs at 2^26 each): the one coefficient it admits outside int32
    is +2^31 itself, and it takes the whole bound, so the sum is then
    2^31 w^i with its other coefficients 0; int32 holds that as -2^31 w^i,
    of the same magnitude, which is all the exact evaluation returns
    (:func:`compile.evaluate.evaluate_abs`, the exact kernels). A rung over
    the bound with at most _ENUMERATED_PARAMS parameters keeps its tables
    where they evaluate equal on all 2^P rows to stripped tables that are
    under it: this keeps noiseless grown cultivation's last rung (12
    parameters, a bound of 2^41.8) as ``tsim_tpu`` compiles it. Every rung
    under the bound keeps ``tsim_tpu``'s tables.
    """
    for i, g in enumerate(g_list):
        n = g.num_vertices()
        if n != 0:
            raise ValueError(
                f"Only scalar graphs can be compiled but graph {i} has {n} vertices"
            )
        if g.scalar.phasevars_pi and not g.scalar.is_zero:
            raise NotImplementedError(
                f"compile_scalar_graphs does not support Scalar.phasevars_pi "
                f"(graph {i} has phasevars_pi={sorted(g.scalar.phasevars_pi)!r})"
            )
    g_list = [g for g in g_list if not g.scalar.is_zero]
    n_params = len(params)
    char_to_idx = {c: i for i, c in enumerate(params)}
    node = _compile_node_phases(g_list, char_to_idx, n_params)
    pairs = _compile_phase_pairs(g_list, char_to_idx, n_params)
    prefactor = _compile_prefactor(g_list)
    tables = CompiledScalarGraphs(
        num_graphs=len(g_list),
        n_params=n_params,
        node_phases=node,
        halfpi_phases=_compile_halfpi_phases(g_list, char_to_idx, n_params),
        pi_products=_compile_pi_products(g_list, char_to_idx, n_params),
        phase_pairs=pairs,
        prefactor=prefactor,
    )
    if coefficient_bound(node, pairs, prefactor) > INT32_LIMIT:
        stripped = replace(tables, prefactor=_strip_factors_of_two(prefactor))
        proven = coefficient_bound(node, pairs, stripped.prefactor) <= INT32_LIMIT
        if not (proven and _same_on_every_row(tables, stripped)):
            tables = stripped
    return tables
