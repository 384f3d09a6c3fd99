"""Closed-form tables of the approximate finisher (``approx_wide``, K6;
``approx_small``, K7b), and their plain reader.

A rung with approximate floatfactors is summed in float32, graph by graph,
so its per-graph product need not be carried as Z[w] integers. A node-phase
factor has a closed form: with ``k = phase + 4 parity``,

    1 + w^k = 2 cos(k pi / 8) e^{i k pi / 8},        w = e^{i pi / 4},

so it is 0 (k = 4) or a sixteenth root of unity times ``2`` (k = 0),
``sqrt 2`` (k = 2, 6), ``c = 2 cos(pi / 8)`` (k = 1, 7) or ``sqrt 2 / c``
(k = 3, 5), because ``2 cos(pi / 8) * 2 cos(3 pi / 8) = sqrt 2``; where the
cosine is negative (k = 5, 6, 7) the sign goes into the phase as half a
turn. A product of such factors is described by four small counts, which one
packed 32-bit word holds:

* bits 0-8   ``z``: factors that are zero;
* bits 9-18  ``e + bias``: factors ``c`` less factors ``sqrt 2 / c``;
* bits 19-27 ``h``: half powers of two (2 for k = 0, 1 for k = 2, 6, 3, 5);
* bits 28-31 ``phi``: the phase in sixteenths of a turn, which wraps as it
  should when the word overflows.

Each live term has two such words, one per parity. The kernel starts from the
graph's ``cf_base`` (the sum of the parity-0 words, the bias, and the static
prefactor's ``w^phase`` as two sixteenths) and adds ``parity * cf_delta`` per
term, the wrapped difference of the term's two words: the fields borrow from
each other on the way, and the total is right because every field's true sum
fits (:func:`build_closed_form` checks that against the rung and raises).
The half-pi total (two sixteenths a unit) and the pi-product sign (eight) go
into ``phi`` too. The phase pairs' factor is not a monomial and stays an
exact Z[w] product. Per graph the value is then

    pairs * 2^(h // 2 + power2) * mag[e, h odd] * unit[phi] * pre,

``mag = c^e`` (times ``sqrt 2`` for an odd ``h``) and ``unit = e^{i pi phi /
8}`` from tables rounded once from float64, ``pre`` the exact floatfactor
times the approximate factor, folded in float64; a graph with ``z > 0``
contributes exactly 0.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.exact_scalar import INV_SQRT2
from ..ops.gf2 import matmul_gf2
from .terms import phase_pair_product

Z_SHIFT, E_SHIFT, H_SHIFT, PHI_SHIFT = 0, 9, 19, 28
FIELD_MAX = {"zero count": (1 << 9) - 1, "count of c": (1 << 10) - 1, "half powers of two": (1 << 9) - 1}

C = 2.0 * np.cos(np.pi / 8)

# (z, e, h, phi) of 1 + w^k for k in [0, 8).
FACTORS = np.array(
    [
        (0, 0, 2, 0),
        (0, 1, 0, 1),
        (0, 0, 1, 2),
        (0, -1, 1, 3),
        (1, 0, 0, 0),
        (0, -1, 1, 13),
        (0, 0, 1, 14),
        (0, 1, 0, 15),
    ],
    dtype=np.int64,
)


def closed_form_layout(tc: int, bias: int, g: int) -> list:
    """The closed-form segments of an approximate rung's table buffer,
    ``(name, shape, kind)`` in storage order: ``tc`` is the most live
    node-phase terms any graph has, ``bias`` the largest ``|e|`` any row can
    reach."""
    return [
        ("cf_delta", (tc, g), "i32"),
        ("cf_base", (g,), "i32"),
        ("cf_pre", (2, g), "f32"),
        ("cf_unit", (16, 2), "f32"),
        ("cf_mag", (2 * bias + 1, 2), "f32"),
    ]


def _pack(fields: np.ndarray) -> np.ndarray:
    """(..., 4) counts (z, e, h, phi) -> packed words, as wrapped int64."""
    z, e, h, phi = (fields[..., j] for j in range(4))
    return (z << Z_SHIFT) + (e << E_SHIFT) + (h << H_SHIFT) + (phi << PHI_SHIFT)


def unit_table(dtype=np.float32) -> np.ndarray:
    """(16, 2) (cos, sin) of k pi / 8, exact at the quarter turns."""
    k = np.arange(16)
    table = np.stack([np.cos(k * np.pi / 8), np.sin(k * np.pi / 8)], axis=1)
    table[k % 8 == 4, 0] = 0.0
    table[k % 8 == 0, 1] = 0.0
    return table.astype(dtype)


def magnitude_table(bias: int, dtype=np.float32) -> np.ndarray:
    """(2 bias + 1, 2): ``c^(j - bias)``, and that times sqrt 2."""
    powers = C ** np.arange(-bias, bias + 1, dtype=np.float64)
    with np.errstate(over="ignore"):  # the caller refuses a table that is not finite
        return np.stack([powers, powers * np.sqrt(2.0)], axis=1).astype(dtype)


def folded_prefactor(floatfactor, approximate) -> np.ndarray:
    """(G,) complex128: the exact floatfactor (G, 4) times the approximate
    factor (G, 2) float32."""
    ff = np.asarray(floatfactor, np.float64).reshape(-1, 4)
    ff = (ff[:, 0] + (ff[:, 1] - ff[:, 3]) * INV_SQRT2) + 1j * (ff[:, 2] + (ff[:, 1] + ff[:, 3]) * INV_SQRT2)
    approx = np.asarray(approximate, np.float32).reshape(-1, 2).astype(np.float64)
    return ff * (approx[:, 0] + 1j * approx[:, 1])


def build_closed_form(circuit) -> dict:
    """Named numpy closed-form segments of one approximate rung (see
    :func:`closed_form_layout`), with ``tc`` and ``bias``. Raises ValueError
    where a count of this rung does not fit its field."""
    np_f, pf = circuit.node_phases, circuit.prefactor
    G = int(circuit.num_graphs)
    phases = np.asarray(np_f.phases, np.int64).reshape(-1, G) & 7
    counts = np.asarray(np_f.counts, np.int64).reshape(G)
    t1 = phases.shape[0]
    tc = int(counts.max(initial=0))
    live = (np.arange(t1)[:, None] < counts[None, :])[:tc]
    inc0 = FACTORS[phases[:tc]] * live[..., None]  # (tc, G, 4)
    inc1 = FACTORS[(phases[:tc] + 4) & 7] * live[..., None]

    hi, lo = np.maximum(inc0, inc1).sum(axis=0), np.minimum(inc0, inc1).sum(axis=0)  # (G, 4)
    bias = int(max(hi[:, 1].max(initial=0), -lo[:, 1].min(initial=0)))
    for name, worst in (
        ("zero count", hi[:, 0]), ("count of c", hi[:, 1] + bias), ("half powers of two", hi[:, 2]),
    ):
        if worst.max(initial=0) > FIELD_MAX[name]:
            raise ValueError(
                f"closed-form tables: the {name} can reach {int(worst.max())} on a rung of {G} graphs "
                f"with T1 = {t1} node-phase slots; its field holds {FIELD_MAX[name]}"
            )
    mag = magnitude_table(bias)
    if not (np.isfinite(mag).all() and (mag >= np.finfo(np.float32).tiny).all()):
        raise ValueError(
            f"closed-form tables: c^{bias} leaves the float32 range on a rung of {G} graphs with "
            f"T1 = {t1} node-phase slots"
        )

    static = np.zeros((G, 4), np.int64)
    static[:, 1] = bias
    static[:, 3] = 2 * (np.asarray(pf.phase_indices, np.int64).reshape(G) & 7)
    base = _pack(inc0).sum(axis=0) + _pack(static)
    delta = _pack(inc1) - _pack(inc0)

    pre = folded_prefactor(pf.floatfactor, pf.approximate_floatfactors)

    def wrapped(a):
        return (a & 0xFFFFFFFF).astype(np.uint32).view(np.int32)

    return dict(
        cf_delta=wrapped(delta), cf_base=wrapped(base),
        cf_pre=np.stack([pre.real, pre.imag]).astype(np.float32),
        cf_unit=unit_table(), cf_mag=mag, tc=tc, bias=bias,
    )


def plain_parities(circuit, x: torch.Tensor) -> dict:
    """The parities the closed-form reader takes, by ``x @ params mod 2``, in
    the per-shot layout of the kernels' front end
    (``bit_lists.sliced_front_end``): ``node`` (B, T1, G), ``alpha`` and
    ``beta`` (B, T4, G), ``tot`` (B, G) the half-pi total mod 8, ``sign``
    (B, G) the pi-product sign bit; int64."""
    np_f, hp, pp, qp = circuit.node_phases, circuit.halfpi_phases, circuit.pi_products, circuit.phase_pairs

    def par(params):  # (T, G, P) -> (B, T, G)
        return matmul_gf2(params.to(torch.uint8), x).to(torch.int64)

    psi = (pp.psi_const.to(torch.int64)[None] + par(pp.psi_params)) & 1
    phi = (pp.phi_const.to(torch.int64)[None] + par(pp.phi_params)) & 1
    return dict(
        node=par(np_f.params), alpha=par(qp.alpha_params), beta=par(qp.beta_params),
        tot=(par(hp.params) * hp.coeffs.to(torch.int64)[None]).sum(dim=1) & 7,
        sign=(psi * phi).sum(dim=1) & 1,
    )


def closed_form_graph_values(tables, x: torch.Tensor, dtype=torch.float64, parities: dict | None = None):
    """Plain reader of the closed-form tables: the per-graph values (re, im),
    each (B, G) of ``dtype``, of the rows ``x`` (B, P) uint8, approximate
    factor included. It walks the kernel's steps (counters, one conversion
    per graph) with torch operations: in float32 on the buffer's float tables,
    to follow the kernel's rounding; in float64 with those tables formed anew
    in float64, to hold the counters and the formula to the exact integers.
    ``parities`` (the layout of :func:`plain_parities`, which is the default)
    gives the rows' parities from elsewhere, such as the kernels' front end."""
    v = tables.views()
    circuit = tables.circuit()
    dev = x.device
    B, G = x.shape[0], tables.num_graphs
    tc, bias = tables.closed_form
    if dtype == torch.float64:
        pf = circuit.prefactor
        pre = folded_prefactor(pf.floatfactor.cpu().numpy(), pf.approximate_floatfactors.cpu().numpy())
        consts = (unit_table(np.float64), magnitude_table(bias, np.float64), np.stack([pre.real, pre.imag]))
        unit_t, mag_t, pre_t = (torch.from_numpy(a).to(dev) for a in consts)
    else:
        unit_t, mag_t, pre_t = (v[k].to(dtype) for k in ("cf_unit", "cf_mag", "cf_pre"))
    par = plain_parities(circuit, x) if parities is None else parities

    def u32(a):  # int32 words as wrapped int64
        return a.to(torch.int64) & 0xFFFFFFFF

    acc = u32(v["cf_base"])[None, :].expand(B, G).clone()
    if tc:  # node-phase slot t is node row t, in the tables' order
        acc = acc + (par["node"][:, :tc].to(torch.int64) * u32(v["cf_delta"])[None]).sum(dim=1)
    if tables.dims[1]:
        acc = acc + ((par["tot"].to(torch.int64) & 7) << (PHI_SHIFT + 1))
    if tables.dims[2]:
        acc = acc + (par["sign"].to(torch.int64) << (PHI_SHIFT + 3))
    acc = acc & 0xFFFFFFFF

    zero = (acc >> Z_SHIFT) & FIELD_MAX["zero count"]
    e_idx = (acc >> E_SHIFT) & FIELD_MAX["count of c"]
    h = (acc >> H_SHIFT) & FIELD_MAX["half powers of two"]
    phi = acc >> PHI_SHIFT

    pairs = phase_pair_product(circuit.phase_pairs, par["alpha"], par["beta"])  # exact, (B, G)
    c = pairs.coeffs.to(dtype)
    pr = c[0] + (c[1] - c[3]) * INV_SQRT2
    pi_ = c[2] + (c[1] + c[3]) * INV_SQRT2
    vanishes = (zero != 0) | (pairs.coeffs == 0).all(dim=0)

    mag = mag_t[e_idx, h & 1]
    power = (h >> 1) + pairs.power.to(torch.int64) + v["pf_pow"].to(torch.int64)[None]
    scale = torch.ldexp(mag, torch.where(vanishes, torch.zeros_like(power), power))
    unit = unit_t[phi]  # (B, G, 2)
    ar = pr * unit[..., 0] - pi_ * unit[..., 1]
    ai = pr * unit[..., 1] + pi_ * unit[..., 0]
    fre, fim = pre_t[0][None] * scale, pre_t[1][None] * scale
    re, im = ar * fre - ai * fim, ar * fim + ai * fre
    nothing = torch.zeros((), dtype=dtype, device=dev)
    return torch.where(vanishes, nothing, re), torch.where(vanishes, nothing, im)


def closed_form_abs(tables, x: torch.Tensor, dtype=torch.float32, parities: dict | None = None) -> torch.Tensor:
    """|graph sum| per row through the closed-form tables: (B, P) uint8 ->
    (B,) of ``dtype``."""
    re, im = closed_form_graph_values(tables, x, dtype, parities)
    sre, sim = re.sum(dim=1), im.sum(dim=1)
    return torch.sqrt(sre * sre + sim * sim)
