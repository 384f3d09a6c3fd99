"""Host tables of the f32 sampling evaluator (host half of ``tsim_tpu``'s
``compile/pallas_sample.py``).

Each rung becomes one :class:`SampleTables` module holding a single flat
``int32`` buffer. The same buffer feeds the CUDA kernel
(``kernels/csrc/sample_eval.cu``) and the plain PyTorch version
(``compile/sample_eval.py``), which reads it through :meth:`SampleTables.views`.
The buffer is a run of segments in the order of :func:`table_layout`:

* float segments (``cos``/``sin`` tables, prefactor) stored as their bits;
* parity parameters packed into ``W = ceil(P / 32)`` ``uint32`` words per
  (term, graph), bit ``p % 32`` of word ``p // 32`` being parameter ``p``
  (read by the plain version and the popcount kernels);
* the same masks as lists of their set parameters (``compile/bit_lists.py``),
  read by the bit-sliced wide kernel.

Dead (term, graph) slots get zeroed ``cos``/``sin`` tables, which makes the
node-phase and phase-pair factors exactly 1, so the evaluator needs no
live masks. The per-graph static prefactor (``w^phase``, exact Z[w]
floatfactor, ``2^(power2 - bias)``, approximate factor) is folded on the
host into one complex pair per graph.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .bit_lists import AHEAD, bit_list_layout, build_bit_lists, flatten_segment, view_segment

_SQRT_HALF = np.float32(0.7071067811865476)

# w^k = exp(i k pi / 4), float32, exact zeros where the value is 0.
_WC = np.cos(np.arange(8) * np.pi / 4).astype(np.float32)
_WS = np.sin(np.arange(8) * np.pi / 4).astype(np.float32)
_WC[[2, 6]] = 0.0
_WS[[0, 4]] = 0.0


def sample_eligible(circuit) -> bool:
    """True if the f32 dynamic range safely covers this circuit's products.

    Unchanged from ``tsim_tpu.compile.pallas_sample.sample_eligible``: the
    per-graph magnitude is bounded by ``2^T1 * 4^T4`` above and by
    ``2^(-0.4 T1 - 0.8 T4)`` below; the prefactor's common power of two is
    folded out (``bias``), so only its spread uses exponent range. A
    positive bias is restored after the magnitude is formed and counts
    against the same budget.
    """
    t1 = int(np.asarray(circuit.node_phases.counts).max(initial=0))
    t4 = int(np.asarray(circuit.phase_pairs.counts).max(initial=0))
    p2 = np.asarray(circuit.prefactor.power2)
    spread = int(p2.max() - p2.min()) if p2.size else 0
    bias = int(p2.max()) if p2.size else 0
    return t1 + 2 * t4 + spread + max(bias, 0) <= 110 and bias >= -200


def _sample_bias(circuit) -> int:
    """Per-circuit power-of-two rescale folded out of the prefactor."""
    p2 = np.asarray(circuit.prefactor.power2)
    return int(p2.max()) if p2.size else 0


def num_words(n_params: int) -> int:
    """``uint32`` words per packed parameter row (at least one)."""
    return max(1, -(-n_params // 32))


def table_layout(t1: int, t2: int, t3: int, t4: int, g: int, w: int, list_words: int = 0) -> list:
    """Segments of the flat buffer: ``(name, shape, kind)`` in storage order.

    ``kind`` is ``"f32"``, ``"i32"`` or ``"words"``; the bit lists, a
    stream of ``list_words`` words a graph, come last. The CUDA kernel's
    ``make_tables`` walks the same order; the two must change together.
    """
    return [
        ("np_cos", (t1, g), "f32"),
        ("np_sin", (t1, g), "f32"),
        ("np_words", (t1, g, w), "words"),
        ("hp_coeffs", (t2, g), "i32"),
        ("hp_words", (t2, g, w), "words"),
        ("pp_psi_c", (t3, g), "i32"),
        ("pp_phi_c", (t3, g), "i32"),
        ("pp_psi_words", (t3, g, w), "words"),
        ("pp_phi_words", (t3, g, w), "words"),
        ("qp_ca", (t4, g), "f32"),
        ("qp_sa", (t4, g), "f32"),
        ("qp_cb", (t4, g), "f32"),
        ("qp_sb", (t4, g), "f32"),
        ("qp_cg", (t4, g), "f32"),
        ("qp_sg", (t4, g), "f32"),
        ("qp_alpha_words", (t4, g, w), "words"),
        ("qp_beta_words", (t4, g, w), "words"),
        ("pre", (2, g), "f32"),
        *bit_list_layout(t1, t2, t3, t4, g, list_words),
    ]


def pack_words(params: np.ndarray, w: int) -> np.ndarray:
    """(T, G, P) 0/1 parameters -> (T, G, W) words, stored as int32 bits."""
    t, g, p = params.shape
    bits = np.zeros((t, g, 32 * w), np.uint64)
    bits[..., :p] = np.asarray(params, np.uint64) & 1
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    words = (bits.reshape(t, g, w, 32) * weights).sum(axis=-1)
    return words.astype(np.uint32).view(np.int32)


def unpack_words(words: torch.Tensor, n_params: int) -> torch.Tensor:
    """(..., W) int32 words -> (..., n_params) 0/1 int32 bits."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words.unsqueeze(-1) >> shifts) & 1  # (..., W, 32)
    return bits.flatten(-2)[..., :n_params]


def _complex_of_coeffs(c: np.ndarray) -> np.ndarray:
    """(4, G) Z[w] coefficients (basis 1, w, w^2, w^3) -> complex128 (G,)."""
    r = np.sqrt(0.5)
    return (c[0] + (c[1] - c[3]) * r) + 1j * (c[2] + (c[1] + c[3]) * r)


def build_tables(circuit, bias: int) -> dict:
    """Named numpy segments of one rung, before flattening (see table_layout)."""
    np_f, hp, pp, qp, pf = (
        circuit.node_phases, circuit.halfpi_phases, circuit.pi_products,
        circuit.phase_pairs, circuit.prefactor,
    )
    w = num_words(int(circuit.n_params))
    np_ph = np.asarray(np_f.phases, np.int64) & 7
    qa = np.asarray(qp.alpha, np.int64) & 7
    qb = np.asarray(qp.beta, np.int64) & 7
    qg = (qa + qb) & 7
    live1 = np.arange(np_ph.shape[0])[:, None] < np.asarray(np_f.counts)[None, :]
    live4 = np.arange(qa.shape[0])[:, None] < np.asarray(qp.counts)[None, :]
    ff = _complex_of_coeffs(np.asarray(pf.floatfactor, np.float64).T)
    phase = np.exp(1j * np.pi / 4 * (np.asarray(pf.phase_indices, np.int64) & 7))
    approx = np.asarray(pf.approximate_floatfactors, np.float64).reshape(-1, 2)
    pre = (
        ff * phase
        * np.exp2(np.asarray(pf.power2, np.float64) - bias)
        * (approx[:, 0] + 1j * approx[:, 1])
    )

    def words(a):
        return pack_words(np.asarray(a, np.uint8), w)

    return dict(
        np_cos=_WC[np_ph] * live1, np_sin=_WS[np_ph] * live1,
        np_words=words(np_f.params),
        hp_coeffs=np.asarray(hp.coeffs, np.int32),
        hp_words=words(hp.params),
        pp_psi_c=np.asarray(pp.psi_const, np.int32),
        pp_phi_c=np.asarray(pp.phi_const, np.int32),
        pp_psi_words=words(pp.psi_params),
        pp_phi_words=words(pp.phi_params),
        qp_ca=_WC[qa] * live4, qp_sa=_WS[qa] * live4,
        qp_cb=_WC[qb] * live4, qp_sb=_WS[qb] * live4,
        qp_cg=_WC[qg] * live4, qp_sg=_WS[qg] * live4,
        qp_alpha_words=words(qp.alpha_params),
        qp_beta_words=words(qp.beta_params),
        pre=np.stack([pre.real, pre.imag]).astype(np.float32),
        **build_bit_lists(circuit),
    )


class SampleTables(nn.Module):
    """One rung's evaluator tables as a single buffer, moved with ``.to(device)``.

    Plain attributes carry the static shape: ``num_graphs``, ``n_params``,
    ``words``, the per-family term maxima ``dims = (T1, T2, T3, T4)``,
    ``list_words`` (words a graph of the bit lists' stream), ``bias``,
    ``eligible`` (:func:`sample_eligible`) and ``per_term``: True sends the
    rung to the per-term kernels, False to the packed ones, None leaves it to
    ``kernels.sample_eval.use_packed``.
    """

    def __init__(self, circuit, per_term: bool | None = None):
        super().__init__()
        self.per_term = per_term
        self.num_graphs = int(circuit.num_graphs)
        self.n_params = int(circuit.n_params)
        self.words = num_words(self.n_params)
        self.eligible = sample_eligible(circuit)
        self.bias = _sample_bias(circuit)
        self.dims = (
            np.asarray(circuit.node_phases.phases).shape[0],
            np.asarray(circuit.halfpi_phases.coeffs).shape[0],
            np.asarray(circuit.pi_products.psi_const).shape[0],
            np.asarray(circuit.phase_pairs.alpha).shape[0],
        )
        tables = build_tables(circuit, self.bias)
        self.list_words = tables["bs_words"].shape[0] - AHEAD
        parts = []
        for name, shape, kind in self.layout():
            a = tables[name]
            if a.shape != shape:
                raise ValueError(f"table {name}: shape {a.shape}, expected {shape}")
            parts.append(flatten_segment(a, kind))
        self.register_buffer("flat", torch.from_numpy(np.concatenate(parts)))

    def layout(self) -> list:
        return table_layout(*self.dims, self.num_graphs, self.words, self.list_words)

    def views(self) -> dict:
        """Named tensor views into ``flat`` (float segments reinterpreted as f32)."""
        out, off = {}, 0
        for name, shape, kind in self.layout():
            n = int(np.prod(shape))
            out[name] = view_segment(self.flat[off : off + n], shape, kind)
            off += n
        return out
