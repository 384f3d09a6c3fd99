"""Host tables of the exact evaluator (host half of ``tsim_tpu``'s
``compile/pallas_evaluate.py``: ``_family_blocks``, ``_live_counts``,
``_prepared_buckets_np``, ``_prepared_small``).

Each rung becomes one :class:`ExactTables` module: a flat ``int32`` buffer
of integer tables plus a (2, G) ``float32`` buffer of approximate
factors. The CUDA kernels (``kernels/csrc/exact_eval.cu``) and the plain
reader (:meth:`ExactTables.circuit`, fed to ``compile/evaluate.py``) walk
the same segments, in the order of :func:`exact_table_layout`. Parity
parameters are packed into ``W = ceil(P / 32)`` words per (term, graph)
with ``sample_tables.pack_words``, any number of them (the plain reader reads
these), and listed by set parameter for the kernels' bit-sliced front ends
(``compile/bit_lists.py``). A rung with approximate
floatfactors also carries the closed-form tables of its node-phase family
(``compile/closed_form.py``), which ``approx_wide`` reads in place of
``np_phases``; a rung without them the node-phase fold
(``compile/node_fold.py``), which ``exact_wide`` reads in place of
``np_phases`` and the bit lists.

The TPU sorts graphs into buckets by live term count, because it pads
each tile to its largest graph. Here each graph keeps its own counts:
``np_counts`` and ``qp_counts`` mask the multiplicative families, and
``hp_len`` and ``pp_len`` (one past each graph's last live term) let the
kernel skip the trailing dead rows of the additive ones. An exact sum is
the same in any order.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..program_io import (
    CompiledScalarGraphs,
    HalfPiPhases,
    NodePhases,
    PhasePairs,
    PiProducts,
    ScalarPrefactor,
)
from .bit_lists import AHEAD, bit_list_layout, flatten_segment, ordered_rows, pack_lists, view_segment
from .closed_form import build_closed_form, closed_form_layout
from .node_fold import build_node_fold, node_fold_layout
from .sample_tables import num_words, pack_words, unpack_words


def exact_table_layout(
    t1: int, t2: int, t3: int, t4: int, g: int, w: int, list_words: int = 0,
    closed_form: tuple | None = None, fold: tuple | None = None,
) -> list:
    """Segments of the flat buffer: ``(name, shape, kind)`` in storage order.

    ``kind`` is ``"i32"``, ``"f32"`` or ``"words"``; an approximate rung's
    closed-form segments (``closed_form = (tc, bias)``, see
    ``closed_form.closed_form_layout``) follow the integer tables, then the bit
    lists, a stream of ``list_words`` words a graph; an exact rung's
    node-phase fold (``fold = (k, f, kept_words, folded_words)``, see
    ``node_fold.node_fold_layout``) comes last. The CUDA kernel's
    ``make_tables`` and ``make_fold`` walk the same order; they must change
    together.
    """
    return [
        ("np_phases", (t1, g), "i32"),
        ("np_words", (t1, g, w), "words"),
        ("np_counts", (g,), "i32"),
        ("hp_coeffs", (t2, g), "i32"),
        ("hp_words", (t2, g, w), "words"),
        ("hp_len", (g,), "i32"),
        ("pp_psi_c", (t3, g), "i32"),
        ("pp_phi_c", (t3, g), "i32"),
        ("pp_psi_words", (t3, g, w), "words"),
        ("pp_phi_words", (t3, g, w), "words"),
        ("pp_len", (g,), "i32"),
        ("qp_alpha", (t4, g), "i32"),
        ("qp_beta", (t4, g), "i32"),
        ("qp_alpha_words", (t4, g, w), "words"),
        ("qp_beta_words", (t4, g, w), "words"),
        ("qp_counts", (g,), "i32"),
        ("pf_phase", (g,), "i32"),
        ("pf_ff", (4, g), "i32"),
        ("pf_pow", (g,), "i32"),
        *(closed_form_layout(*closed_form, g) if closed_form else []),
        *bit_list_layout(t1, t2, t3, t4, g, list_words),
        *(node_fold_layout(*fold[:2], t2, t3, t4, g, *fold[2:]) if fold else []),
    ]


def _live_length(live: np.ndarray) -> np.ndarray:
    """(T, G) live flags -> (G,) one past each graph's last live row."""
    t = live.shape[0]
    if t == 0:
        return np.zeros(live.shape[1], np.int32)
    last = t - np.argmax(live[::-1], axis=0)
    return np.where(live.any(axis=0), last, 0).astype(np.int32)


def build_exact_tables(circuit) -> dict:
    """Named numpy segments of one rung, before flattening (see exact_table_layout)."""
    np_f, hp, pp, qp, pf = (
        circuit.node_phases, circuit.halfpi_phases, circuit.pi_products,
        circuit.phase_pairs, circuit.prefactor,
    )
    w = num_words(int(circuit.n_params))

    def words(a):
        return pack_words(np.asarray(a, np.uint8), w)

    def i32(a):
        return np.asarray(a, np.int64).astype(np.int32)

    rows = ordered_rows(circuit)
    hp_live = ((i32(hp.coeffs) & 7) != 0) & np.asarray(hp.params, bool).any(axis=2)
    psi_live = (i32(pp.psi_const) & 1 != 0) | np.asarray(pp.psi_params, bool).any(axis=2)
    phi_live = (i32(pp.phi_const) & 1 != 0) | np.asarray(pp.phi_params, bool).any(axis=2)
    return dict(
        np_phases=i32(np_f.phases) & 7,
        np_words=words(np_f.params),
        np_counts=i32(np_f.counts),
        hp_coeffs=i32(hp.coeffs),
        hp_words=words(hp.params),
        hp_len=_live_length(hp_live),
        pp_psi_c=i32(pp.psi_const) & 1,
        pp_phi_c=i32(pp.phi_const) & 1,
        pp_psi_words=words(pp.psi_params),
        pp_phi_words=words(pp.phi_params),
        pp_len=_live_length(psi_live & phi_live),
        qp_alpha=i32(qp.alpha) & 7,
        qp_beta=i32(qp.beta) & 7,
        qp_alpha_words=words(qp.alpha_params),
        qp_beta_words=words(qp.beta_params),
        qp_counts=i32(qp.counts),
        pf_phase=i32(pf.phase_indices) & 7,
        pf_ff=i32(pf.floatfactor).T,
        pf_pow=i32(pf.power2),
        **pack_lists(*rows),
        **({} if pf.has_approximate_floatfactors else build_node_fold(circuit, *rows)),
    )


class ExactTables(nn.Module):
    """One rung's exact-evaluator tables, moved with ``.to(device)``.

    Buffers: ``flat`` (int32, the segments of :func:`exact_table_layout`)
    and ``approx`` ((2, G) float32 approximate factors, re then im).
    Plain attributes: ``num_graphs``, ``n_params``, ``words``, the
    per-family term maxima ``dims = (T1, T2, T3, T4)``, ``list_words``
    (words a graph of the bit lists' stream), ``approximate`` (the rung has
    approximate floatfactors) and ``closed_form``: ``(tc, bias)`` of an
    approximate rung's closed-form tables (the most live node-phase terms a
    graph has, the largest ``|e|`` a row can reach), None on an exact rung;
    ``fold``: ``(k, f, kept_words, folded_words)`` of an exact rung's
    node-phase fold (the most kept and folded terms a graph has, the words a
    graph of its two streams), None on an approximate rung;
    ``fold_offsets``: the words of ``flat`` where the fold's segments and its
    folded terms' stream start; ``node_terms``: the exact
    rung's live node-phase terms and how many of them the fold takes, summed
    over its graphs.
    """

    def __init__(self, circuit):
        super().__init__()
        self.num_graphs = int(circuit.num_graphs)
        self.n_params = int(circuit.n_params)
        self.words = num_words(self.n_params)
        self.approximate = bool(circuit.prefactor.has_approximate_floatfactors)
        self.dims = (
            np.shape(circuit.node_phases.phases)[0],
            np.shape(circuit.halfpi_phases.coeffs)[0],
            np.shape(circuit.pi_products.psi_const)[0],
            np.shape(circuit.phase_pairs.alpha)[0],
        )
        tables = build_exact_tables(circuit)
        self.closed_form = None
        if self.approximate:
            closed = build_closed_form(circuit)
            self.closed_form = (closed.pop("tc"), closed.pop("bias"))
            tables.update(closed)
        self.list_words = tables["bs_words"].shape[0] - AHEAD
        self.fold = self.node_terms = None
        if not self.approximate:
            self.fold = (
                tables["nf_phases"].shape[0], tables["nv_meta"].shape[0],
                tables["nf_words"].shape[0] - AHEAD, tables["nv_words"].shape[0] - AHEAD,
            )
            live = int(tables["np_counts"].sum())
            self.node_terms = (live, live - int(tables["nf_counts"].sum()))
        parts, offsets, at = [], {}, 0
        for name, shape, kind in self.layout():
            a = tables[name]
            if a.shape != shape:
                raise ValueError(f"table {name}: shape {a.shape}, expected {shape}")
            parts.append(flatten_segment(a, kind))
            offsets[name], at = at, at + len(parts[-1])
        self.fold_offsets = (offsets["nf_phases"], offsets["nv_base"]) if self.fold else (0, 0)
        self.register_buffer("flat", torch.from_numpy(np.concatenate(parts)))
        approx = np.asarray(circuit.prefactor.approximate_floatfactors, np.float32).reshape(-1, 2)
        self.register_buffer("approx", torch.from_numpy(np.ascontiguousarray(approx.T)))

    def layout(self) -> list:
        return exact_table_layout(
            *self.dims, self.num_graphs, self.words, self.list_words, self.closed_form, self.fold
        )

    def views(self) -> dict:
        """Named tensor views into ``flat`` (float segments reinterpreted as f32)."""
        out, off = {}, 0
        for name, shape, kind in self.layout():
            n = int(np.prod(shape))
            out[name] = view_segment(self.flat[off : off + n], shape, kind)
            off += n
        return out

    def circuit(self) -> CompiledScalarGraphs:
        """The rung read back from the buffers, as ``program_io`` dataclasses
        with tensor leaves on the buffers' device (the plain version's input)."""
        v = self.views()

        def bits(name):
            return unpack_words(v[name], self.n_params).to(torch.uint8)

        return CompiledScalarGraphs(
            num_graphs=self.num_graphs,
            n_params=self.n_params,
            node_phases=NodePhases(
                phases=v["np_phases"], params=bits("np_words"), counts=v["np_counts"]
            ),
            halfpi_phases=HalfPiPhases(coeffs=v["hp_coeffs"], params=bits("hp_words")),
            pi_products=PiProducts(
                psi_const=v["pp_psi_c"], psi_params=bits("pp_psi_words"),
                phi_const=v["pp_phi_c"], phi_params=bits("pp_phi_words"),
            ),
            phase_pairs=PhasePairs(
                alpha=v["qp_alpha"], alpha_params=bits("qp_alpha_words"),
                beta=v["qp_beta"], beta_params=bits("qp_beta_words"),
                counts=v["qp_counts"],
            ),
            prefactor=ScalarPrefactor(
                phase_indices=v["pf_phase"],
                floatfactor=v["pf_ff"].T,
                power2=v["pf_pow"],
                approximate_floatfactors=self.approx.T,
                has_approximate_floatfactors=self.approximate,
            ),
        )
