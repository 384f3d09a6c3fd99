"""Compilation of scalar ZX graphs into static-shaped numpy arrays.

Extracts the five symbolic term families from each graph's scalar into
padded arrays (semantics of reference ``tsim/compile/compile.py``), working
from our own :class:`tsim_tpu_torch.zx.scalar.Scalar`. The arrays are
written straight into ``program_io``'s dataclasses, with the dtypes and
layouts ``tsim_tpu`` gives them.
"""

from __future__ import annotations

from fractions import Fraction

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


def compile_scalar_graphs(g_list: list[ZXGraph], params: list[str]) -> CompiledScalarGraphs:
    """Compile vertex-free graphs into static-shaped arrays for evaluation."""
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
    return CompiledScalarGraphs(
        num_graphs=len(g_list),
        n_params=n_params,
        node_phases=_compile_node_phases(g_list, char_to_idx, n_params),
        halfpi_phases=_compile_halfpi_phases(g_list, char_to_idx, n_params),
        pi_products=_compile_pi_products(g_list, char_to_idx, n_params),
        phase_pairs=_compile_phase_pairs(g_list, char_to_idx, n_params),
        prefactor=_compile_prefactor(g_list),
    )
