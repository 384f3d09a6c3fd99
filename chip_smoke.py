#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tsim_tpu_torch) once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero:

1. the card's name and power limit (``nvidia-smi``); no CUDA means exit 1;
2. build of the CUDA kernel library from the sources in this checkout;
3. kernel vs plain PyTorch version on every d3 distillation rung at the
   main path's shape (2^20 seeded rows plus a probe row, as one ladder
   call of a 2^20-shot batch), within rtol 1e-5 of the row's magnitude
   (atol 1e-8); on the same inputs both are timed with CUDA events on the
   first 103-graph rung (wide) and the 6-graph rung (small), the kernels in
   device time (each launch between its own events, queued behind a sleep:
   a short launch takes the card less time than the host takes to enqueue it);
4. the main path: ``distillation_d3(p=0.05).compile_detector_sampler(
   seed=0, device="cuda").sample(8 * 2**20, batch_size=2**20,
   append_observables=True)``, with the kernels' launch counts, the norm
   deviation (at most 3e-3), shots/s, and per-output z-scores against the
   means tsim_tpu sampled (pooled sigma, at most 4 * sqrt(2));
5. the exact kernels vs the plain exact evaluator on every rung of the
   cultivation program, the d3 program and the d3 state-probability
   program, at 2^20 + 1 seeded rows: exact kernels give equal magnitudes,
   approximate ones agree within rtol 1e-5 of the row's magnitude; each
   kernel and the plain version are timed with CUDA events on one rung (the
   kernels in device time), the small exact kernel (K7a) also at 1024 and
   16,384 rows and on the state-probability norm rung, the small approximate
   kernel (K7b) on d3's two small rungs (5 and 6 graphs) at 1024, 16,384
   and 2^20 + 1 rows, and the wide approximate kernel (K6) also on d3's three
   wide rungs and on 2^20 + 1 rows that the state-probability path draws
   itself; on every rung K5 takes, its int32 partials equal the plain
   reader of its node-phase fold (``compile/node_fold.py``) bit for bit on
   4097 seeded rows and 4097 rows that solve the folded terms;
6. state probabilities: ``distillation_d3(p=0.05).compile_state_probs(
   seed=0, device="cuda").probability_of(state, batch_size=2**20)`` for
   the exported states (values finite, in [0, 1]; calls/s and rows/s), and
   ``_probability_body`` on the exported noise rows against tsim_tpu's
   values (rtol 1e-5);
7. exact-mode sampling: ``cultivation_d3(p=0.001, checks=2)
   .compile_detector_sampler(seed=0, device="cuda", evaluation="exact")
   .sample(4 * 2**20, batch_size=2**20)`` (norm deviation at most 1e-5,
   shots/s), the exported 4096-shot replay of tsim_tpu's exact sampling
   reproduced bit for bit, and one 2^20-shot batch of d3 distillation in
   exact mode (norm deviation, z-scores as in phase 4);
8. the per-term f32 kernels (K3a ``per_term_wide``, K3b ``per_term_small``)
   and the bit-sliced ones (K1 ``wide``, K2 ``small``, any row) vs the plain
   version on every rung of d3, 1-check
   and 2-check cultivation, d5 distillation (the rungs phase 20 samples) and
   on two seeded rungs over 160 parameters, at
   2^20 + 1 rows; K1 must equal K3a, and K2 K3b, bit for bit; within rtol 1e-5 of
   the row's mass (the sum over graphs of |product|: cultivation's graph
   sums cancel to near zero on most rows, where only the mass sets the
   scale of f32 rounding); timed in turns with the plain version, the kernels
   in device time: K1 and K3a
   on cultivation's 307-graph rung, K2 and K3b on d3's 6-graph rung and on
   1-check cultivation's last 16-graph rung (K2 there also at 1024 and
   16,384 rows); K1's two instances, 32 and 128 shots a block, equal bit for
   bit on every wide rung at 2^20 + 1 rows, and on cultivation's 307-graph
   and d3's first 103-graph rung also at 128 to 65,536 rows, each of those
   timed in device time (the sweep that chose the row count between them);
   K3a at 4097 rows (its 32-shot block on rows of up to four words) equal to
   K1 bit for bit on every wide rung, and timed beside K1's 32-shot block on
   d3's first 103-graph rung;
9. the start-up self-test of the f32 kernels (K4): its result, and its
   four launches and their plain versions timed, each call on the card
   alone (events queued behind a sleep, so host time stays out), and their
   sum;
10. postselected f32 cultivation: ``cultivation_d3(p=0.001, checks=2)
    .compile_detector_sampler(seed=0, device="cuda").sample(4 * 2**20,
    batch_size=2**20, postselection_mask=ones, use_detector_reference_sample=True,
    use_observable_reference_sample=True, separate_observables=True)``;
    the mask applied to the rows as users do; norm deviation at most 3e-3;
    the reference sample equal to tsim_tpu's on every output that is
    deterministic without noise; the survivor fraction and the survivors'
    per-output means within 4 * sqrt(2) pooled sigma of tsim_tpu's exported
    postselected reference (its means flipped where an output random without
    noise drew the other reference value);
    shots/s and survivors/s; launches of K1, K2 and K4 (whose cached result
    is forgotten just before, so the path runs it as a new process would);
11. the same path compiled with ``per_term=True``: launches of K3a and K3b
    and the same checks;
12. 1-check cultivation in f32 mode, 4 * 2**20 shots, z-scores against the
    means tsim_tpu sampled;
13. the stage ablation of the wide kernel (K8, ``dev/torch_kernel_ablate.py``)
    on 2-check cultivation's 307-graph rung and on 1-check cultivation's
    64-graph rung at 2^20 rows: its oracles and the time of every variant
    (``par1`` and ``par-all`` time the bit-sliced parity stage alone);
14. the exact kernels past 128 parameters: seeded rungs of all four families
    over 130 and 200 parameters with 5 and 40 graphs, exact and approximate,
    at 2^16 + 1 rows, kernel vs the plain exact evaluator (exact rungs
    bit-equal, approximate ones within rtol 1e-5 of the batch's largest
    magnitude: their random graph sums cancel on some rows);
15. the stage split of the wide approximate kernel (K6) on the state-probability
    rung at 2^20 rows: ``empty``, ``par-all`` and ``full``, which must equal K6
    bit for bit;
16. small batches: ``distillation_d3(p=0.05).compile_detector_sampler(seed=0,
    device="cuda").sample(16 * 4096, batch_size=4096, append_observables=True)``,
    a notebook's batch, whose wide rungs take K1's 32-shot block: launches,
    norm deviation, shots/s and z-scores as in phase 4;
17. host synchronisations: d3 f32 ``sample()`` of 6 and of 2 batches of
    2^20 shots after two warm-up calls of 2 batches, under
    ``torch.cuda.set_sync_debug_mode("warn")``: the synchronising calls of
    each and where each was made, their difference over 4 (the steady
    state's per batch; counts that differ fail the run) and what is left a
    call; the batch loop's own wait on an earlier batch's copy event is not
    one of them;
18. checkpointing: the d3 sampler saved after one 2^20-shot batch and
    loaded; the two give bit-identical next 2^16 shots;
19. the port's host compile path on the card's host (no JAX there): the
    circuits of the four committed workloads (d3's detector sampler and
    state probabilities, 1- and 2-check cultivation) and of d5 distillation
    built by ``tsim_tpu_torch.models`` and compiled by ``sampler.compile_circuit``,
    each equal to its committed ``.npz`` leaf for leaf (dtype, shape, value);
    each compile's time and stages, the g++ build of the native ZX engine,
    and the planner, which must be the native one throughout (the Python
    fallback plans otherwise, so "python" or "mixed" fails the run);
20. d5 distillation, compiled on the host and sampled on the card:
    ``distillation_d5(p=0.02).compile_detector_sampler(seed=0)`` takes phase
    19's verified d5 program from the in-process AOT cache, then ``.sample(
    8 * 2**20, batch_size=2**20, append_observables=True)`` after one warm-up
    batch, through the pipelined loop: launches of K1 and K2, norm deviation
    (at most 3e-3), shots/s, and per-output z-scores against the means
    tsim_tpu sampled (``programs/distillation_d5_p0.02.npz``, 2^18 shots);
21. the d7 surface-code memory of ``bench_suite.py``'s panel (p = 0.001),
    compiled on the host (equal to ``programs/surface_code_d7_p0.001.npz``
    leaf for leaf) and ``.compile_detector_sampler(seed=0)`` on the card: a
    fully-direct program, drawn on the host by the C++ Pauli-frame engine
    (``direct_route`` must read ``native_frame``, and no kernel may launch);
    shots/s of one ``sample(4 * 2**20, separate_observables=True)`` after a
    warm-up call of the same size; the DEM's time and its text's sha256,
    which must equal tsim_tpu's; every detector and observable mean within 5
    sigma of its exact marginal from the DEM, and within 4 * sqrt(2) pooled
    sigma of tsim_tpu's means; then d5 through both routes (``device="cpu"``
    host channels, and the card's native frame engine), 2^20 shots each,
    within 4 * sqrt(2) pooled sigma of each other;
22. m2d of one native run's measurement records (d7, 2^16 shots) equal to
    that run's detector and observable rows bit for bit; the card's exact
    state probabilities (``compile_state_probs(seed=0).probability_of``) of
    a fixed five-qubit circuit with T, R_Z and U3 gates on each of its 32
    outcomes, within 1e-5 of the port's statevector oracle (``VecSampler``),
    and the exact kernels that launched;
23. the sharded path (``mesh=``, ``tsim_tpu_torch/parallel/shard.py``) on a
    mesh of every card where there are two or more, else of two replicas of
    card 0 (printed, with the devices' names): phase 4's call with
    ``mesh=mesh`` (norm deviation at most 3e-3; means against tsim_tpu's as
    in phase 4 and, per output, within 5 sigma of phase 4's unsharded run,
    as ``__graft_entry__.py:80-99`` holds tsim_tpu's sharded sampler; K1
    and K2 launched on every device as often as phase 4's run launched
    them, times the shards there; shots/s beside phase 4's); phase 17's
    sync count on the mesh (0 a batch); ``sharded_sampler_step`` on 2^16
    rows of injected noise and draw uniforms equal to
    ``sample_program_with_deviation`` on the whole except borderline rows,
    its norm deviation the max of the shards'; phase 10's postselected
    cultivation on the mesh (same bounds; survivors/s); phase 6's state
    probabilities on the mesh equal to the unsharded estimator of the same
    seed within rtol 1e-6 (calls/s). Its launches are printed per device,
    on lines of their own, and are not added to the kernels line;
24. noisy grown cultivation, ``cultivation_d3_grown(p=0.001, checks=2)``
    (12 rungs, up to 1084 graphs), compiled on this host (seconds and
    stages printed; native planner) and sampled on the card with
    ``compile_detector_sampler(seed=0, evaluation="exact")``: 2^20 shots
    after a warm-up batch, norm deviation at most 1e-5 with any warning of
    the norm monitor failing the run, K5 and K7a launched; then in f32 mode
    (seed 1) 4 * 2^20 shots, norm deviation at most 3e-3, K1 and K2
    launched, every output's mean within 4 * sqrt(2) pooled sigma of the
    exact run's; then the 1084-graph rung alone at 2^20 + 1 rows: K5 equal
    to the plain exact evaluator bit for bit (and its partials to the plain
    reader of its fold, as in phase 5) and K1 within rtol 1e-5 of the row's
    mass, each timed beside its bound;
25. batch planning, on the samplers of phases 4 (d3 f32), 7 (2-check
    exact), 10 (postselected 2-check f32), 12 (1-check f32) and 24 (grown
    exact and f32), not built again: each one's default batch
    (``DEFAULT_ROWS_PER_CARD`` or its memory budget, whichever is less) and
    the model's bytes a row (``sampler._peak_bytes_per_sample``); one batch
    of that size by default, whose peak device memory above what was
    allocated before (``torch.cuda.max_memory_allocated`` after
    ``reset_peak_memory_stats``) must be at most the model's bytes times the
    rows, and the ratio of the two; the shots/s of default calls beside
    calls at ``batch_size=2**20``, in turns, and beside the phase's own.
    The measured batch runs eagerly (the sampler's captured steps are
    dropped first); the next call captures the step again, and its peak,
    the graph's memory beside the replay's copy of its bits, is held to the
    same model;
26. the noise-draw kernel (``kernels/csrc/noise_draw.cu``) against the
    plain draw (``DeviceChannelSampler.sample_from_uniforms``) on the same
    2^20 rows of seeded uniforms, bit for bit, on the noise of d3
    distillation, d3 state probabilities, 1- and 2-check cultivation, d5
    distillation, grown cultivation (phase 24's) and the d7 surface code (W
    = 11 words, its table read through L1/L2; the plain version runs on
    2^17-row slices, its bits being row by row); the kernel timed in device
    time and the plain version with CUDA events, beside the bound ((4C + F)
    bytes a row over 3.35 TB/s);
27. the graphed batch step (``sampler._StepGraph``) on the samplers of
    phases 4 (d3 f32), 12 (1-check f32), 7 (2-check exact) and 24 (grown
    f32), not built again, and on d3 sharded over every card or two
    replicas of card 0: after a call of two batches that warms the step
    up and captures it (its time and the capture's printed), a
    ``sample()`` of 4 batches of 2^20 that replays
    every batch equals the eager ``_sample_batch`` steps from the same
    generator state bit for bit, deviation included; the noise kernel ran
    in it; shots/s of the same call graphed and eager (graphs switched
    off), two of each in turns, replays and eager batches a call, and the host's enqueue time of
    a batch replayed and eager (every shard's, for the mesh).

Phases 4, 7, 10, 12, 16, 20, 23 and 27 sample through the pipelined batch
loop (``sampler._RowsToHost``), whose full batches replay each shard's
captured step from a size's third batch on; phase 6 draws one batch a call. Each path of
phases 4, 6, 7, 10 to 13, 16, 20 to 24 runs with the launch counts
set to 0 just before it and read just after; a kernel of the path that was not
launched fails the run (in phase 21, any kernel launched does). The line before the last is a JSON summary of the
kernels, each with its least possible time on the card (``bound_ms``, see
``f32_bound``, ``exact_bound`` and ``approx_bound``; a kernel faster than its
bound fails the run); the last line is ``{"ok": true,
"device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from dev.torch_kernel_ablate import device_ms, state_prob_path_rows, time_ms
from dev.torch_surface_scaling import host_cpu

RTOL, ATOL = 1e-5, 1e-8
NORM_TOL = 3e-3
Z_BOUND = 4 * math.sqrt(2)
MAIN_BATCH = 1 << 20
MAIN_SHOTS = 8 * MAIN_BATCH
KERNEL_ROWS = MAIN_BATCH + 1  # one ladder call: the batch plus the probe row
SOURCE = "tsim_tpu_torch/kernels/csrc/sample_eval.cu"
REPLACES = {
    "wide": "tsim_tpu/compile/pallas_sample.py:356",  # _kernel_sample
    "small": "tsim_tpu/compile/pallas_sample.py:374",  # _kernel_sample_t
}
EXACT_NORM_TOL = 1e-5
EXACT_SOURCE = "tsim_tpu_torch/kernels/csrc/exact_eval.cu"
EXACT_REPLACES = {
    "exact_wide": "tsim_tpu/compile/pallas_evaluate.py:270",  # _kernel_exact (K5)
    "approx_wide": "tsim_tpu/compile/pallas_evaluate.py:301",  # _kernel_approx (K6)
    "exact_small": "tsim_tpu/compile/pallas_evaluate.py:814",  # _kernel_exact_t (K7a)
    "approx_small": "tsim_tpu/compile/pallas_evaluate.py:842",  # _kernel_approx_t (K7b)
}
# (program, graphs) of the rung each exact kernel is timed on.
EXACT_TIMED = {
    "exact_wide": ("cultivation", 307),
    "exact_small": ("cultivation", 4),
    "approx_wide": ("d3_state_probs", 172),
    "approx_small": ("d3", 6),
}
PER_TERM_REPLACES = {
    "per_term_wide": "tsim_tpu/compile/pallas_sample.py:365",  # _kernel_sample_unpacked (K3a)
    "per_term_small": "tsim_tpu/compile/pallas_sample.py:383",  # _kernel_sample_t_unpacked (K3b)
}
SELF_TEST_REPLACES = "tsim_tpu/compile/pallas_sample.py:405"  # _tpack_probe (K4)
NOISE_SOURCE = "tsim_tpu_torch/kernels/csrc/noise_draw.cu"
# No pl.pallas_call: the draw XLA fuses into tsim_tpu's one-jit batch step.
NOISE_REPLACES = "tsim_tpu/noise/device_channels.py:124"
NOISE_SLICE = 1 << 17  # phase 26: rows a slice of the plain draw
ABLATE_REPLACES = "dev/kernel_ablate.py:132"  # run_variant -> _body_ablate (K8)
CULTIVATION_SHOTS = 4 * MAIN_BATCH
SMALL_BATCH = 4096  # phase 16: a batch whose wide rungs take the 32-shot block of K1
SMALL_SHOTS = 16 * SMALL_BATCH
SWEEP_ROWS = (128, 1024, 4096, 8192, 16384, 32768, 65536)  # phase 8: rows at which K1's two instances are timed
SWEPT = {("cultivation", 307), ("d3", 103)}  # (program, graphs) of the rungs swept
SMALL_EXACT_ROWS = (1024, 16384)  # phase 5: K7a and K7b also at these rows
FOLD_ROWS = 4097  # phases 5 and 24: rows a kind on which K5's partials meet the plain reader of its fold
WIDE_PARAMS = 160  # parameters of the seeded rungs past the packed kernels' four words
LONG_ROW_RUNGS = [(p, g) for p in (130, 200) for g in (5, 40)]  # (parameters, graphs) of phase 14
LONG_ROW_COUNT = (1 << 16) + 1
DEVICE = "cuda"
GROWN_SHOTS = 4 * MAIN_BATCH  # phase 24: f32 shots of noisy grown cultivation
PLAN_CALLS = 2  # phase 25: calls a path and way, in turns

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


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def rows(n_params: int, count: int, seed: int, device):
    """``count`` seeded 0/1 rows whose last one is row 0 with its last bit cleared."""
    x = np.random.default_rng(seed).integers(0, 2, size=(count, n_params)).astype(np.uint8)
    x[-1] = x[0]
    if n_params:
        x[-1, -1] = 0
    return torch.from_numpy(x).to(device)


def timed_once(fn):
    """(result, milliseconds) of one call, with CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def check_z(label: str, means, n: int, ref, n_ref: int, ref_label: str = "tsim_tpu") -> None:
    """z-scores of means over ``n`` shots against ``ref_label``'s (tsim_tpu's)
    over ``n_ref``, with the pooled sigma; fails beyond 4 * sqrt(2)."""
    means, ref = np.atleast_1d(np.asarray(means, np.float64)), np.atleast_1d(np.asarray(ref, np.float64))
    pooled = (means * n + ref * n_ref) / (n + n_ref)
    sigma = np.sqrt(np.maximum(pooled * (1 - pooled), 1e-12) * (1 / n + 1 / n_ref))
    z = np.abs(means - ref) / sigma
    print(f"{label}: means  " + " ".join(f"{m:.4f}" for m in means))
    print(f"{label}: {ref_label} " + " ".join(f"{m:.4f}" for m in ref))
    print(f"{label}: z      " + " ".join(f"{v:.2f}" for v in z) + f" (max {z.max():.2f}, bound {Z_BOUND:.2f})")
    if not (z < Z_BOUND).all():
        fail(f"{label}: a mean disagrees with {ref_label}'s beyond 4 * sqrt(2) sigma")


def check_means(label: str, out: np.ndarray, exported) -> None:
    """Per-output z-scores of ``out``'s means against the means tsim_tpu sampled."""
    check_z(label, out.mean(axis=0, dtype=np.float64), out.shape[0],
            exported.reference_means, int(exported.meta["reference_shots"]))


def synchronize(mesh=None) -> None:
    """Wait for every device of ``mesh`` (the current card without one)."""
    for device in [None] if mesh is None else mesh.distinct:
        torch.cuda.synchronize(device)


def check_launched(label: str, launches: dict, expected) -> None:
    print(f"{label}: kernel launches {launches}", flush=True)
    missing = [k for k in expected if launches[k] <= 0]
    if missing:
        fail(f"{label}: kernels {missing} of the path were not launched")


def check_fold_partials(label: str, t, x, seed: int) -> None:
    """K5's int32 partials, coefficients and powers, against the plain reader
    of its node-phase fold (``compile/node_fold.py``: K5's arithmetic step
    for step on the CPU, the dead slots' reduce steps one by one, the sums in
    the kernel's order), bit for bit, on FOLD_ROWS of the seeded rows ``x``
    and on FOLD_ROWS rows that solve the folded terms."""
    from tsim_tpu_torch.compile import node_fold
    from tsim_tpu_torch.kernels import exact_eval as kernel

    for kind, rows_ in (("seeded", x[:FOLD_ROWS]), ("standing", node_fold.standing_rows(t, FOLD_ROWS, seed))):
        rows_ = rows_.to(x.device)
        out_c, out_p = kernel.exact_partials(t, rows_)
        want_c, want_p = node_fold.kernel_partials(t, rows_.cpu(), kernel.graph_tile(t.num_graphs))
        if not (torch.equal(out_c.cpu(), want_c) and torch.equal(out_p.cpu(), want_p)):
            fail(f"{label}: exact_wide's partials differ from the plain reader of its fold on {kind} rows")
        share = float(node_fold.vanishing(t, rows_).float().mean())
        print(f"{label}: exact_wide's int32 partials equal the plain reader of its fold bit for bit on "
              f"{FOLD_ROWS} {kind} rows ({share:.3f} of the products vanish; node terms live, folded: "
              f"{t.node_terms})", flush=True)


def exact_kernel_phase(programs: dict, dev) -> tuple[dict, dict, dict]:
    """Phase 5: each exact kernel vs the plain exact evaluator on every rung
    at KERNEL_ROWS rows, and the timings of EXACT_TIMED.

    Returns ({kernel: max abs err}, {kernel: (kernel ms, plain ms, bound ms,
    bound by, rung)}, {approximate kernel: its bound ms counted as the exact
    finisher's is}).
    """
    from tsim_tpu_torch.compile.evaluate import evaluate_abs
    from tsim_tpu_torch.compile.exact_eval import evaluate_abs_exact
    from tsim_tpu_torch.compile.exact_tables import ExactTables
    from tsim_tpu_torch.kernels import exact_eval as kernel

    max_abs = dict.fromkeys(kernel.KERNELS, 0.0)
    timing, as_exact = {}, {}
    seed = 200
    for label, exported in programs.items():
        rungs = [c for comp in exported.program.components for c in comp.compiled_scalar_graphs]
        for i, csg in enumerate(rungs):
            t = ExactTables(csg).to(dev)
            name = f"{'approx' if t.approximate else 'exact'}_{kernel.configuration(t.num_graphs)}"
            x = rows(t.n_params, KERNEL_ROWS, seed=seed, device=dev)
            seed += 1
            got = evaluate_abs_exact(t, x)
            want = evaluate_abs(t.circuit(), x)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                fail(f"{label} rung {i}: kernel output is not finite")
            err = (got - want).abs()
            if t.approximate:
                ok = bool((err <= ATOL + RTOL * want).all())
                bound = f"rtol {RTOL}"
            else:
                ok = torch.equal(got, want)
                bound = "equal"
            max_abs[name] = max(max_abs[name], float(err.max()))
            rel = float((err / want.clamp_min(1e-30)).max())
            print(
                f"{label} rung {i}: G={t.num_graphs} P={t.n_params} {name}, B={KERNEL_ROWS}: "
                f"max rel err {rel:.3e}, max abs err {float(err.max()):.3e} ({bound}) "
                f"-> {'ok' if ok else 'FAIL'}",
                flush=True,
            )
            if not ok:
                fail(f"{label} rung {i}: {name} disagrees with the plain exact evaluator")
            del got, want, err
            if name == "exact_wide":
                check_fold_partials(f"{label} rung {i} G={t.num_graphs}", t, x, seed)
            if EXACT_TIMED[name] == (label, t.num_graphs) and name not in timing:
                # In turns, plain, kernel, kernel, plain; the check above
                # was the plain version's warm-up, and it is slow enough
                # to be timed once per turn.
                partials = kernel.approx_partials if t.approximate else kernel.exact_partials
                _, p1 = timed_once(lambda: evaluate_abs(t.circuit(), x))
                k1 = device_ms(lambda: partials(t, x))
                d1 = time_ms(lambda: evaluate_abs_exact(t, x))
                k2 = device_ms(lambda: partials(t, x))
                _, p2 = timed_once(lambda: evaluate_abs(t.circuit(), x))
                bound = exact_bound(csg, t, KERNEL_ROWS)
                if t.approximate:
                    as_exact[name], by = bound
                    bound = approx_bound(csg, t, KERNEL_ROWS)
                    print(f"bound of {name} on {label} G={t.num_graphs}: {bound[0]:.4f} ms ({bound[1]}; "
                          f"{approx_operations(csg):.1f} operations a row), {as_exact[name]:.4f} ms ({by}) as the exact finisher's "
                          "is counted", flush=True)
                timing[name] = ((k1 + k2) / 2, (p1 + p2) / 2, *bound, f"{label} G={t.num_graphs}")
                print(
                    f"time at B={KERNEL_ROWS}, {label} G={t.num_graphs} ({name}): bound "
                    f"{bound[0]:.4f} ms ({bound[1]}), kernel "
                    f"{k1:.4f} / {k2:.4f} ms (device time), dispatch with the partials' combine {d1:.4f} ms, "
                    f"plain {p1:.2f} / {p2:.2f} ms",
                    flush=True,
                )
                if name == "exact_small":
                    few = {n: device_ms(lambda n=n: kernel.exact_partials(t, x[:n]), reps=20)
                           for n in SMALL_EXACT_ROWS}
                    print(f"exact_small on {label} G={t.num_graphs}: " + ", ".join(
                        f"{n} rows {ms:.4f} ms" for n, ms in few.items()) + " (device time)", flush=True)
            elif name == "exact_small" and label == "d3_state_probs":
                print(f"time at B={KERNEL_ROWS}, {label} G={t.num_graphs} P={t.n_params} (exact_small, the norm "
                      f"rung): kernel {device_ms(lambda: kernel.exact_partials(t, x)):.4f} ms (device time)",
                      flush=True)
            elif name == "approx_wide":
                bound = approx_bound(csg, t, KERNEL_ROWS)
                print(f"time at B={KERNEL_ROWS}, {label} G={t.num_graphs} ({name}): bound {bound[0]:.4f} ms "
                      f"({bound[1]}), kernel {time_ms(lambda: kernel.approx_partials(t, x)):.4f} ms", flush=True)
            if name == "approx_small":
                few = {n: device_ms(lambda n=n: kernel.approx_partials(t, x[:n]), reps=20)
                       for n in (*SMALL_EXACT_ROWS, KERNEL_ROWS)}
                print(f"approx_small on {label} G={t.num_graphs}: " + ", ".join(
                    f"{n} rows {ms:.4f} ms" for n, ms in few.items()) + " (device time)", flush=True)
            del t, x
            torch.cuda.empty_cache()
    if set(timing) != set(EXACT_TIMED):
        fail(f"no rung with the timed graph counts {EXACT_TIMED}")
    return max_abs, timing, as_exact


def path_rows_time(circuit) -> None:
    """Phase 5, K6 on the rows the state-probability path evaluates: f-bits
    drawn by its own noise sampler, the first exported state tiled behind
    them. Seeded uniform rows make almost every graph product of the joint
    rung vanish; the path's rows are mostly zeros and few products vanish."""
    from tsim_tpu_torch.compile.evaluate import evaluate_abs
    from tsim_tpu_torch.compile.exact_eval import evaluate_abs_exact
    from tsim_tpu_torch.kernels import exact_eval as kernel

    joint, x = state_prob_path_rows(circuit, KERNEL_ROWS)
    got, want = evaluate_abs_exact(joint, x), evaluate_abs(joint.circuit(), x)
    err = (got - want).abs()
    ok = bool(torch.isfinite(got).all() and (err <= ATOL + RTOL * want).all())
    ms = time_ms(lambda: kernel.approx_partials(joint, x))
    print(f"d3_state_probs G={joint.num_graphs} approx_wide on {KERNEL_ROWS} rows of the path's own noise "
          f"({float((want > 0).float().mean()):.4f} of them nonzero): max rel err "
          f"{float((err / want.clamp_min(1e-30)).max()):.3e} (rtol {RTOL}) -> {'ok' if ok else 'FAIL'}; "
          f"kernel {ms:.4f} ms", flush=True)
    if not ok:
        fail("approx_wide disagrees with the plain exact evaluator on the path's own rows")


def state_probs_path(circuit) -> dict:
    """Phase 6: state probabilities of d3 distillation on the card."""
    from tsim_tpu_torch.kernels import exact_eval as kernel

    replay = circuit.load_state_probs().replay
    states = replay["states"]
    sp = circuit.compile_state_probs(seed=0, device=DEVICE)
    sp.probability_of(states[0], batch_size=1024)  # warm-up
    torch.cuda.synchronize()
    kernel.reset_launch_counts()
    t0 = time.perf_counter()
    probs = [sp.probability_of(s, batch_size=MAIN_BATCH) for s in states]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernel.launch_counts)
    check_launched("state probs", launches, ["exact_small", "approx_wide"])
    for i, p in enumerate(probs):
        if p.shape != (MAIN_BATCH,) or not (np.isfinite(p).all() and (p >= 0).all() and (p <= 1).all()):
            fail(f"state probs: state {i}: values not finite in [0, 1] or of the wrong shape")
        print(f"state probs: state {i}: mean {p.mean():.6e}, max {p.max():.6e}, nonzero {np.mean(p > 0):.4f}")
    n = len(states)
    print(
        f"state probs: {n} calls of {MAIN_BATCH} rows in {wall:.3f} s = {n / wall:.2f} calls/s, "
        f"{n * MAIN_BATCH / wall:.0f} rows/s",
        flush=True,
    )
    f = torch.from_numpy(replay["f"]).to(DEVICE)
    worst = 0.0
    for i, s in enumerate(states):
        got = sp._probability_body(f, s).cpu().numpy()
        want = replay["probabilities"][i]
        err = np.abs(got - want)
        worst = max(worst, float((err / np.maximum(want, 1e-30)).max()))
        if not (err <= RTOL * want).all():
            fail(f"state probs: state {i}: replay rows disagree with tsim_tpu beyond rtol {RTOL}")
    print(f"state probs: {f.shape[0]} replay rows x {n} states vs tsim_tpu: max rel err {worst:.3e} -> ok")
    return launches


def exact_sampling_path(cultivation, d3, planned: dict) -> tuple[dict, dict]:
    """Phase 7: exact-mode sampling of 2-check cultivation, its replay, and
    one batch of d3 distillation in exact mode. The cultivation sampler and
    its rate go into ``planned`` (phase 25)."""
    from tsim_tpu_torch.kernels import exact_eval as kernel
    from tsim_tpu_torch.sampler import sample_program_with_deviation

    exported = cultivation.load()
    sampler = cultivation.compile_detector_sampler(seed=0, device=DEVICE, evaluation="exact")
    sampler.sample(MAIN_BATCH, batch_size=MAIN_BATCH)  # warm-up
    torch.cuda.synchronize()
    kernel.reset_launch_counts()
    t0 = time.perf_counter()
    out = sampler.sample(CULTIVATION_SHOTS, batch_size=MAIN_BATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cult_launches = dict(kernel.launch_counts)
    check_launched("cultivation exact", cult_launches, ["exact_wide", "exact_small"])
    print(f"cultivation exact: shape {out.shape}, dtype {out.dtype}; detector means "
          + " ".join(f"{m:.4f}" for m in out.mean(axis=0)), flush=True)
    if out.shape != (CULTIVATION_SHOTS, exported.num_detectors) or out.dtype != np.bool_:
        fail(f"cultivation exact: expected ({CULTIVATION_SHOTS}, {exported.num_detectors}) bool samples")
    dev_norm = sampler.last_norm_deviation
    print(f"cultivation exact: max norm deviation {dev_norm:.3e} (limit {EXACT_NORM_TOL})", flush=True)
    if not (math.isfinite(dev_norm) and dev_norm <= EXACT_NORM_TOL):
        fail("cultivation exact: norm deviation above the exact tolerance")
    print(
        f"cultivation exact: {CULTIVATION_SHOTS} shots in {wall:.3f} s = "
        f"{CULTIVATION_SHOTS / wall:.0f} shots/s (batch {MAIN_BATCH})",
        flush=True,
    )
    planned["2-check exact (phase 7)"] = (sampler, CULTIVATION_SHOTS / wall, {})

    r = exported.replay
    f = sampler._device_channels.from_uniforms(torch.from_numpy(r["noise_uniforms"]).to(DEVICE))
    draws = [torch.from_numpy(d).to(DEVICE) for d in r["draw_uniforms"]]
    bits, dev = sample_program_with_deviation(sampler._tables, f, None, uniforms=draws)
    bits = bits.cpu().numpy()
    differ = int((bits != r["bits"]).any(axis=1).sum())
    print(f"cultivation exact: replay of {len(bits)} tsim_tpu shots: {differ} rows differ, "
          f"norm deviation {float(dev[0]):.3e}", flush=True)
    if bits.shape != r["bits"].shape or differ:
        fail("cultivation exact: the replay does not reproduce tsim_tpu's bits")

    d3_sampler = d3.compile_detector_sampler(seed=0, device=DEVICE, evaluation="exact")
    d3_sampler.sample(1024, batch_size=1024)  # warm-up
    torch.cuda.synchronize()
    kernel.reset_launch_counts()
    t0 = time.perf_counter()
    out = d3_sampler.sample(MAIN_BATCH, batch_size=MAIN_BATCH, append_observables=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    d3_launches = dict(kernel.launch_counts)
    check_launched("d3 exact", d3_launches, ["approx_small", "approx_wide", "exact_small"])
    dev_norm = d3_sampler.last_norm_deviation
    print(f"d3 exact: max norm deviation {dev_norm:.3e} (limit {EXACT_NORM_TOL}); "
          f"{MAIN_BATCH} shots in {wall:.3f} s = {MAIN_BATCH / wall:.0f} shots/s", flush=True)
    if not (math.isfinite(dev_norm) and dev_norm <= EXACT_NORM_TOL):
        fail("d3 exact: norm deviation above the exact tolerance")
    check_means("d3 exact", out, d3.load())
    return cult_launches, d3_launches


def wide_sweep(t, circuit, x, label: str) -> None:
    """Phase 8: K1's two instances on the first n rows of ``x`` for n in
    SWEEP_ROWS, equal bit for bit, each timed in device time in turns (32,
    128, 128, 32 shots a block)."""
    from tsim_tpu_torch.kernels import sample_eval as kernel

    faster = []
    for n in SWEEP_ROWS:
        xs = x[:n]
        if not torch.equal(kernel.launch(t, xs, "wide", _block_shots=32),
                           kernel.launch(t, xs, "wide", _block_shots=128)):
            fail(f"{label} G={t.num_graphs}: wide's two instances differ at {n} rows")

        def timed(shots):
            return device_ms(lambda: kernel.launch(t, xs, "wide", _block_shots=shots), reps=10)

        a1, b1, b2, a2 = timed(32), timed(128), timed(128), timed(32)
        small, large = (a1 + a2) / 2, (b1 + b2) / 2
        faster.append(32 if small < large else 128)
        bound = f32_bound(circuit, 4 * t.flat.numel(), n)
        print(f"wide instances, {label} G={t.num_graphs}, {n} rows: equal bit for bit; bound {bound[0]:.6f} ms, "
              f"32 shots a block {a1:.4f} / {a2:.4f} ms, 128 shots {b1:.4f} / {b2:.4f} ms (device time); "
              f"the row count takes {kernel.wide_block_shots(n)}", flush=True)
    print(f"wide instances, {label} G={t.num_graphs}: the faster block at {list(SWEEP_ROWS)} rows: {faster} "
          f"shots (the dispatch takes 32 below {kernel.WIDE_SMALL_ROWS} rows)", flush=True)


def per_term_phase(programs: dict, dev) -> tuple[dict, dict]:
    """Phase 8: the per-term and the bit-sliced f32 kernels vs the plain
    version on every rung at KERNEL_ROWS rows (the two of a layout equal bit
    for bit, K1's two instances too), the timings of K1/K3a on cultivation's
    307-graph rung and K2/K3b on d3's 6-graph rung and on 1-check
    cultivation's last 16-graph rung, K1's instances swept over SWEEP_ROWS on
    the rungs of SWEPT, and the 32-shot instance timed on d3's first
    103-graph rung at the rows of phase 16's batch.

    Returns ({configuration or "wide_32": max abs err}, {configuration or
    "wide_32": (kernel ms, plain ms, bound ms, bound by, rung)})."""
    from tsim_tpu_torch.compile.sample_eval import sample_product_sum_reference, synthetic_rung
    from tsim_tpu_torch.compile.sample_tables import SampleTables
    from tsim_tpu_torch.kernels import sample_eval as kernel

    timed = {("cultivation", 307): ("wide", "per_term_wide"), ("d3", 6): ("small", "per_term_small")}
    heaviest_small = ("cultivation_checks1", 16, 27)  # (program, graphs, parameters)
    rungs = [
        (label, c) for label, exported in programs.items()
        for comp in exported.program.components for c in comp.compiled_scalar_graphs
    ]
    rungs += [(f"seeded P={WIDE_PARAMS}", synthetic_rung(s, g, WIDE_PARAMS, (6, 4, 4, 2)))
              for s, g in ((11, 40), (12, 8))]
    max_abs = dict.fromkeys((*kernel.CONFIGURATIONS, "wide_32", "per_term_wide_32"), 0.0)
    timing, swept = {}, set()
    for i, (label, c) in enumerate(rungs):
        t = SampleTables(c).to(dev)
        x = rows(t.n_params, KERNEL_ROWS, seed=300 + i, device=dev)
        want, mass = sample_product_sum_reference(t, x, with_mass=True)
        scale, norm = mass[:, None], want.norm(dim=1, keepdim=True)
        layout = kernel.layout(t.num_graphs)
        configs = [f"per_term_{layout}", layout]
        outs = {}
        for config in configs:
            got = outs[config] = kernel.launch(t, x, config)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                fail(f"{label} G={t.num_graphs}: {config} output is not finite")
            err = (got - want).abs()
            rel = float((err / scale.clamp_min(1e-30)).max())
            rel_norm = float((err / norm.clamp_min(1e-30)).max())
            ok = bool((err <= ATOL + RTOL * scale).all())
            max_abs[config] = max(max_abs[config], float(err.max()))
            print(f"{label} G={t.num_graphs} P={t.n_params} W={t.words} {config}, B={KERNEL_ROWS}: "
                  f"max err {rel:.3e} of the row's mass ({rel_norm:.3e} of |row|), "
                  f"max abs err {float(err.max()):.3e} -> {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"{label} G={t.num_graphs}: {config} disagrees with the plain version beyond rtol {RTOL}")
            del got, err
        same = torch.equal(*outs.values())
        print(f"{label} G={t.num_graphs}: {configs[0]} equals {configs[1]} bit for bit: {same}", flush=True)
        if not same:
            fail(f"{label} G={t.num_graphs}: {configs[1]} and {configs[0]} add the same f32 values in "
                 "the same order and must agree bit for bit")
        if layout == "wide":
            got = kernel.launch(t, x, "wide", _block_shots=32)
            max_abs["wide_32"] = max(max_abs["wide_32"], float((got - want).abs().max()))
            same = torch.equal(got, outs["wide"])
            print(f"{label} G={t.num_graphs}: wide's 32-shot block equals its 128-shot block bit for bit: {same}",
                  flush=True)
            if not same:
                fail(f"{label} G={t.num_graphs}: wide's two instances add the same f32 values in the same order "
                     "and must agree bit for bit")
            # K3a's own 32-shot block, which launches of fewer than
            # WIDE_SMALL_ROWS rows take on rows of up to four words.
            xs = x[: SMALL_BATCH + 1]
            got = kernel.launch(t, xs, "per_term_wide")
            if t.words <= kernel.PER_TERM_REGISTER_WORDS:
                max_abs["per_term_wide_32"] = max(max_abs["per_term_wide_32"],
                                                  float((got - want[: xs.shape[0]]).abs().max()))
            same = torch.equal(got, outs["wide"][: xs.shape[0]])
            print(f"{label} G={t.num_graphs}: per_term_wide at {xs.shape[0]} rows "
                  f"({kernel.per_term_wide_groups(xs.shape[0], t.words) * 32} shots a block) equals wide bit for "
                  f"bit: {same}", flush=True)
            if not same:
                fail(f"{label} G={t.num_graphs}: per_term_wide's blocks add the same f32 values in the same order "
                     "as wide's and must agree bit for bit")
            del got
        del outs
        if (label, t.num_graphs) in SWEPT and (label, t.num_graphs) not in swept:
            swept.add((label, t.num_graphs))
            wide_sweep(t, c, x, label)
        if (label, t.num_graphs) == ("d3", 103) and "wide_32" not in timing:
            xs = x[: SMALL_BATCH + 1]
            k1 = device_ms(lambda: kernel.launch(t, xs, "wide", _block_shots=32), reps=20)
            q1 = device_ms(lambda: kernel.launch(t, xs, "per_term_wide"), reps=20)
            p1 = time_ms(lambda: sample_product_sum_reference(t, xs))
            q2 = device_ms(lambda: kernel.launch(t, xs, "per_term_wide"), reps=20)
            k2 = device_ms(lambda: kernel.launch(t, xs, "wide", _block_shots=32), reps=20)
            p2 = time_ms(lambda: sample_product_sum_reference(t, xs))
            bound = f32_bound(c, 4 * t.flat.numel(), xs.shape[0])
            rung = f"{label} G={t.num_graphs}, B={xs.shape[0]}"
            timing["wide_32"] = ((k1 + k2) / 2, (p1 + p2) / 2, *bound, rung)
            timing["per_term_wide_32"] = ((q1 + q2) / 2, (p1 + p2) / 2, *bound, rung)
            print(f"time at B={xs.shape[0]} (phase 16's batch), {label} G={t.num_graphs}, 32 shots a block: "
                  f"bound {bound[0]:.6f} ms ({bound[1]}), wide {k1:.4f} / {k2:.4f} ms, per_term_wide "
                  f"{q1:.4f} / {q2:.4f} ms (device time), plain {p1:.4f} / {p2:.4f} ms", flush=True)
        if (label, t.num_graphs, t.n_params) == heaviest_small:
            a = device_ms(lambda: kernel.launch(t, x, "small"))
            b = device_ms(lambda: kernel.launch(t, x, "per_term_small"))
            bound = f32_bound(c, 4 * t.flat.numel(), KERNEL_ROWS)
            few = {n: device_ms(lambda n=n: kernel.launch(t, x[:n], "small"), reps=20) for n in (1024, 16384)}
            print(f"time at B={KERNEL_ROWS}, {label} G={t.num_graphs} P={t.n_params}: bound {bound[0]:.4f} ms "
                  f"({bound[1]}), small {a:.4f} ms, per_term_small {b:.4f} ms; small at "
                  + ", ".join(f"{n} rows {ms:.4f} ms" for n, ms in few.items()) + " (device time)", flush=True)
        pair = timed.get((label, t.num_graphs))
        if pair and pair[0] not in timing:
            # In turns: plain, packed, per-term, per-term, packed, plain.
            packed, per_term = pair
            _, p1 = timed_once(lambda: sample_product_sum_reference(t, x))
            a1 = device_ms(lambda: kernel.launch(t, x, packed))
            b1 = device_ms(lambda: kernel.launch(t, x, per_term))
            b2 = device_ms(lambda: kernel.launch(t, x, per_term))
            a2 = device_ms(lambda: kernel.launch(t, x, packed))
            _, p2 = timed_once(lambda: sample_product_sum_reference(t, x))
            bound = f32_bound(c, 4 * t.flat.numel(), KERNEL_ROWS)
            rung = f"{label} G={t.num_graphs}"
            timing[packed] = ((a1 + a2) / 2, (p1 + p2) / 2, *bound, rung)
            timing[per_term] = ((b1 + b2) / 2, (p1 + p2) / 2, *bound, rung)
            print(f"time at B={KERNEL_ROWS}, {rung}: bound {bound[0]:.4f} ms ({bound[1]}), "
                  f"{packed} {a1:.4f} / {a2:.4f} ms, {per_term} {b1:.4f} / {b2:.4f} ms (device time), "
                  f"plain {p1:.2f} / {p2:.2f} ms", flush=True)
        del t, x, want, mass, scale, norm
        torch.cuda.empty_cache()
    if len(timing) != 6 or swept != SWEPT:
        fail(f"no rung with the timed graph counts {sorted(timed)} or the swept ones {sorted(SWEPT)}")
    return max_abs, timing


def self_test_phase(dev) -> tuple[float, tuple]:
    """Phase 9: the K4 self-test's result, and its four launches timed
    against their plain versions, each launch on the card alone. Returns
    (max abs err, (ms, plain ms, bound ms, bound by, rung)), the times
    summed over the four launches."""
    from tsim_tpu_torch.compile import sample_eval
    from tsim_tpu_torch.kernels import sample_eval as kernel

    errors, total = timed_once(lambda: sample_eval.self_test(dev))
    print(f"self-test: {total:.3f} ms, max rel err by configuration "
          + ", ".join(f"{c} {e:.3e}" for c, e in errors.items()), flush=True)
    tables, x = sample_eval.probe_inputs(dev)
    circuits = sample_eval.probe_rungs()
    max_abs, ms, plain_ms, bound_ms, by = 0.0, 0.0, 0.0, 0.0, set()
    for c in kernel.CONFIGURATIONS:
        layout = c.removeprefix("per_term_")
        t = tables[layout]
        want = sample_eval.sample_product_sum_reference(t, x)
        max_abs = max(max_abs, float((kernel.launch(t, x, c, count_as="self_test") - want).abs().max()))
        k = device_ms(lambda: kernel.launch(t, x, c, count_as="self_test"))
        p = device_ms(lambda: sample_eval.sample_product_sum_reference(t, x))
        b = f32_bound(circuits[layout], 4 * t.flat.numel(), x.shape[0])
        shots = {"wide": kernel.wide_block_shots(x.shape[0]),
                 "per_term_wide": 32 * kernel.per_term_wide_groups(x.shape[0], t.words)}.get(c)
        block = f", {shots} shots a block" if shots else ""
        print(f"self-test launch {c} ({x.shape[0]} rows{block}): bound {b[0]:.6f} ms ({b[1]}), "
              f"kernel {k:.4f} ms, plain {p:.4f} ms (device time)", flush=True)
        ms, plain_ms, bound_ms = ms + k, plain_ms + p, bound_ms + b[0]
        by.add(b[1])
    bound_by = "bytes" if by == {"bytes"} else "operations"
    print(f"self-test launches, summed: bound {bound_ms:.6f} ms, kernels {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms", flush=True)
    return max_abs, (ms, plain_ms, bound_ms, bound_by, "probe G=128 and 8, P=8")


def reference_fold(cultivation) -> np.ndarray:
    """Outputs of ``cultivation`` that are random without noise: those that
    take both values on 256 draws of the all-zero noise row, by the plain
    version on the CPU. Each package's reference sample takes its own draw
    there, so only those outputs may differ between them."""
    from tsim_tpu_torch.sampler import sample_program_with_deviation

    sampler = cultivation.compile_detector_sampler(seed=0, device="cpu")
    f = torch.zeros((256, sampler._device_channels.num_f), dtype=torch.uint8)
    out, _ = sample_program_with_deviation(sampler._tables, f, sampler._generator)
    out = out.numpy()
    return ~(out == out[:1]).all(axis=0)


def postselected_path(cultivation, label: str, expected, random_outputs: np.ndarray,
                      per_term: bool = False, mesh=None, planned: dict | None = None) -> dict:
    """Phases 10, 11 and 23: postselected f32 sampling of 2-check cultivation
    with both reference samples, checked against tsim_tpu's export.
    ``random_outputs`` marks the outputs that are random without noise;
    ``per_term`` compiles the sampler onto the per-term kernels; ``mesh``
    shards it (the card otherwise). ``planned``, if given, takes the sampler,
    its rate and the call's options (phase 25)."""
    from tsim_tpu_torch.compile import sample_eval
    from tsim_tpu_torch.kernels import sample_eval as kernel

    exported = cultivation.load()
    nd = exported.num_detectors
    mask = np.ones(nd, bool)
    kw = dict(
        batch_size=MAIN_BATCH, postselection_mask=mask, use_detector_reference_sample=True,
        use_observable_reference_sample=True, separate_observables=True,
    )
    sampler = cultivation.compile_detector_sampler(
        seed=0, device=DEVICE if mesh is None else None, per_term=per_term, mesh=mesh)
    sampler.sample(MAIN_BATCH, **kw)  # warm-up
    synchronize(mesh)
    kernel.reset_launch_counts()
    sample_eval.reset_self_test()
    t0 = time.perf_counter()
    det, obs = sampler.sample(CULTIVATION_SHOTS, **kw)
    synchronize(mesh)
    wall = time.perf_counter() - t0
    launches = dict(kernel.launch_counts)
    check_launched(label, launches, expected)
    n_obs = exported.program.num_outputs - nd
    if det.shape != (CULTIVATION_SHOTS, nd) or obs.shape != (CULTIVATION_SHOTS, n_obs) or det.dtype != np.bool_:
        fail(f"{label}: expected ({CULTIVATION_SHOTS}, {nd}) and ({CULTIVATION_SHOTS}, {n_obs}) bool samples")
    dev_norm = sampler.last_norm_deviation
    print(f"{label}: max norm deviation {dev_norm:.3e} (limit {NORM_TOL})", flush=True)
    if not (math.isfinite(dev_norm) and dev_norm <= NORM_TOL):
        fail(f"{label}: norm deviation above the f32 tolerance")
    keep = ~(det & mask).any(axis=1)
    survivors = int(keep.sum())
    print(f"{label}: {CULTIVATION_SHOTS} shots in {wall:.3f} s = {CULTIVATION_SHOTS / wall:.0f} shots/s, "
          f"{survivors} survivors = {survivors / wall:.0f} survivors/s (batch {MAIN_BATCH})", flush=True)
    if planned is not None:
        planned[f"{label} (phase 10)"] = (
            sampler, CULTIVATION_SHOTS / wall, {k: v for k, v in kw.items() if k != "batch_size"})
    meta, replay = exported.meta, exported.replay
    check_z(f"{label}: survivor fraction", keep.mean(), CULTIVATION_SHOTS,
            meta["survivor_fraction"], int(meta["reference_shots"]))
    # An output that is random without noise takes one draw in each
    # package's reference; where the two draws differ, the fold flips it.
    # Every other output must have the same reference in both.
    port_ref = sampler._reference_sample()
    tsim_ref = replay["reference_sample"].astype(bool)
    print(f"{label}: reference rows: port {port_ref.astype(int).tolist()}, "
          f"tsim_tpu {tsim_ref.astype(int).tolist()}, random without noise "
          f"{random_outputs.astype(int).tolist()}", flush=True)
    differ = port_ref != tsim_ref
    if (differ & ~random_outputs).any():
        fail(f"{label}: the reference sample differs from tsim_tpu's on outputs "
             f"{np.flatnonzero(differ & ~random_outputs).tolist()}, deterministic without noise")
    flip = differ & random_outputs
    ref_means = np.where(flip, 1 - replay["survivor_means"], replay["survivor_means"])
    check_z(f"{label}: survivor means", np.hstack([det, obs])[keep].mean(axis=0, dtype=np.float64),
            survivors, ref_means, int(meta["reference_survivors"]))
    return launches


def checks1_path(cultivation, planned: dict) -> dict:
    """Phase 12: 1-check cultivation in f32 mode; the sampler and its rate
    go into ``planned`` (phase 25)."""
    from tsim_tpu_torch.kernels import sample_eval as kernel

    exported = cultivation.load()
    sampler = cultivation.compile_detector_sampler(seed=0, device=DEVICE)
    sampler.sample(MAIN_BATCH, batch_size=MAIN_BATCH, append_observables=True)  # warm-up
    torch.cuda.synchronize()
    kernel.reset_launch_counts()
    t0 = time.perf_counter()
    out = sampler.sample(CULTIVATION_SHOTS, batch_size=MAIN_BATCH, append_observables=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernel.launch_counts)
    check_launched("cultivation 1-check", launches, ["wide", "small"])
    if out.shape != (CULTIVATION_SHOTS, exported.program.num_outputs) or out.dtype != np.bool_:
        fail("cultivation 1-check: samples of the wrong shape or type")
    dev_norm = sampler.last_norm_deviation
    print(f"cultivation 1-check: max norm deviation {dev_norm:.3e} (limit {NORM_TOL}); "
          f"{CULTIVATION_SHOTS} shots in {wall:.3f} s = {CULTIVATION_SHOTS / wall:.0f} shots/s", flush=True)
    if not (math.isfinite(dev_norm) and dev_norm <= NORM_TOL):
        fail("cultivation 1-check: norm deviation above the f32 tolerance")
    check_means("cultivation 1-check", out, exported)
    planned["1-check f32 (phase 12)"] = (sampler, CULTIVATION_SHOTS / wall, {"append_observables": True})
    return launches


def small_batch_path(circuit) -> dict:
    """Phase 16: d3 distillation f32 sampling in batches of SMALL_BATCH shots,
    whose wide rungs take the 32-shot block of K1."""
    from tsim_tpu_torch.kernels import sample_eval as kernel

    exported = circuit.load()
    sampler = circuit.compile_detector_sampler(seed=0, device=DEVICE)
    sampler.sample(SMALL_BATCH, batch_size=SMALL_BATCH, append_observables=True)  # warm-up
    torch.cuda.synchronize()
    kernel.reset_launch_counts()
    t0 = time.perf_counter()
    out = sampler.sample(SMALL_SHOTS, batch_size=SMALL_BATCH, append_observables=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernel.launch_counts)
    check_launched("small batches", launches, ["wide_32", "small"])
    if launches["wide"]:
        fail(f"small batches: batches of {SMALL_BATCH} shots took the 128-shot block of K1")
    if out.shape != (SMALL_SHOTS, exported.program.num_outputs) or out.dtype != np.bool_:
        fail("small batches: samples of the wrong shape or type")
    dev_norm = sampler.last_norm_deviation
    print(f"small batches: max norm deviation {dev_norm:.3e} (limit {NORM_TOL}); {SMALL_SHOTS} shots in "
          f"{wall:.3f} s = {SMALL_SHOTS / wall:.0f} shots/s (batch {SMALL_BATCH})", flush=True)
    if not (math.isfinite(dev_norm) and dev_norm <= NORM_TOL):
        fail("small batches: norm deviation above the f32 tolerance")
    check_means("small batches", out, exported)
    return launches


def sync_phase(sampler, label: str = "syncs") -> None:
    """Phases 17 and 23: the host synchronisations of d3 f32 ``sample()``
    calls of 6 and 2 batches, under ``set_sync_debug_mode("warn")``, after
    two warm-up calls of 2 batches (the self-test's sync falls in those). A
    sync a batch shows as a difference between the two counts; what is left
    is made once a call."""
    import warnings

    for _ in range(2):
        sampler.sample(2 * MAIN_BATCH, batch_size=MAIN_BATCH)
    synchronize(sampler._mesh)
    counts, where = {}, {}
    for n in (6, 2):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                sampler.sample(n * MAIN_BATCH, batch_size=MAIN_BATCH)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        # torch's own notice that the mode is a prototype is said once a
        # process and is no sync; its message mentions synchronizing too
        syncs = [w for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
        counts[n] = len(syncs)
        where[n] = {}
        for w in syncs:
            key = f"{Path(w.filename).name}:{w.lineno}"
            where[n][key] = where[n].get(key, 0) + 1
    print(f"{label}: sample() of 6 batches {counts[6]} (at {where[6] or 'nowhere'}), of 2 batches "
          f"{counts[2]} (at {where[2] or 'nowhere'}): {(counts[6] - counts[2]) / 4:g} a batch in the "
          f"steady state, {counts[2] - (counts[6] - counts[2]) / 2:g} a call", flush=True)
    if counts[6] != counts[2]:
        fail(f"{label}: the two calls made different numbers of host synchronisations, "
             "so the batch loop synchronises with the host per batch")
    if counts[2] == 0:
        fail(f"{label}: the debug mode counted no sync, not even the call's read of the norm "
             "deviation: the count is at fault")


def checkpoint_phase(circuit) -> None:
    """Phase 18: the d3 sampler saved after one batch and loaded on the card;
    the next 2^16 shots of both must be equal."""
    import tempfile

    from tsim_tpu_torch.sampler import CompiledDetectorSampler

    sampler = circuit.compile_detector_sampler(seed=2, device=DEVICE)
    sampler.sample(MAIN_BATCH, batch_size=MAIN_BATCH)
    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        path = Path(tmp) / "d3.ckpt"
        t0 = time.perf_counter()
        sampler.save(path)
        restored = CompiledDetectorSampler.load(path)
        took = time.perf_counter() - t0
        size = path.stat().st_size
    shots = 1 << 16
    a = sampler.sample(shots, batch_size=shots, append_observables=True)
    b = restored.sample(shots, batch_size=shots, append_observables=True)
    same = bool(np.array_equal(a, b))
    print(f"checkpoint: saved and loaded in {took:.3f} s ({size} bytes, device {restored.device}); "
          f"next {shots} shots equal: {same}", flush=True)
    if not same or restored.device.type != "cuda":
        fail("checkpoint: the restored sampler does not continue the sample stream on the card")


def host_compile_phase() -> None:
    """Phase 19: the port compiles the circuits of the committed programs on
    this host, each equal to its ``.npz`` leaf for leaf; fails unless the
    native ZX engine planned them."""
    from tsim_tpu_torch import models, program_io
    from tsim_tpu_torch.compile import aot_cache
    from tsim_tpu_torch.models import exported
    from tsim_tpu_torch.sampler import compile_circuit
    from tsim_tpu_torch.zx import native_simplify

    t0 = time.perf_counter()
    if native_simplify._load() is None:
        fail("host compile: the native ZX engine did not build or load; the Python planner "
             "would plan other decompositions than the committed programs'")
    print(f"host compile: native ZX engine built and loaded in {time.perf_counter() - t0:.2f} s", flush=True)
    workloads = [
        ("d3", models.distillation_d3(p=0.05), True, "sequential", exported.D3_PROGRAM),
        ("d3 state probabilities", models.distillation_d3(p=0.05), False, "joint",
         exported.D3_STATE_PROBS_PROGRAM),
        ("cultivation 1-check", models.cultivation_d3(p=0.001, checks=1), True, "sequential",
         exported.CULTIVATION_CHECKS1_PROGRAM),
        ("cultivation 2-check", models.cultivation_d3(p=0.001, checks=2), True, "sequential",
         exported.CULTIVATION_PROGRAM),
        ("d5", models.distillation_d5(p=0.02), True, "sequential", exported.D5_PROGRAM),
    ]
    for label, circuit, sample_detectors, mode, path in workloads:
        aot_cache.clear_memory()  # a compile of its own, as a new process makes
        t0 = time.perf_counter()
        got, stats = compile_circuit(circuit, sample_detectors=sample_detectors, mode=mode)
        took = time.perf_counter() - t0
        bad = program_io.leaf_differences(got, program_io.load_npz(path))
        rungs = [c.num_graphs for comp in got.program.components for c in comp.compiled_scalar_graphs]
        leaves = len(program_io.flatten(got)[0])
        print(f"host compile: {label}: {took:.3f} s ({stats}), {len(rungs)} rungs, largest {max(rungs)}, "
              f"total {sum(rungs)} graphs, {leaves} leaves; equal to {path.name}: {not bad}", flush=True)
        if stats["planner"] != "native":
            fail(f"host compile: {label} was not planned by the native engine alone "
                 f"(planner {stats['planner']!r})")
        if bad:
            fail(f"host compile: {label} differs from {path.name} in {bad[:8]}")


def d5_path() -> dict:
    """Phase 20: d5 distillation compiled on the host and sampled on the card."""
    from tsim_tpu_torch.compile import aot_cache
    from tsim_tpu_torch.kernels import sample_eval as kernel
    from tsim_tpu_torch.models import distillation_d5, exported

    reference = exported.distillation_d5(p=0.02).load()
    circuit = distillation_d5(p=0.02)
    verified = aot_cache.fetch(aot_cache.cache_key(
        str(circuit._stim_circ), sample_detectors=True, mode="sequential", strategy="cat5"))
    t0 = time.perf_counter()
    sampler = circuit.compile_detector_sampler(seed=0)
    took = time.perf_counter() - t0
    if verified is None or sampler._program is not verified.program:
        fail("d5: the sampler does not sample phase 19's verified program")
    print(f"d5: sampler built in {took:.3f} s on {sampler.device} from phase 19's verified program "
          f"(an AOT memory hit: no compile here; phase 19 printed its compile time); {sampler!r}", flush=True)
    sampler.sample(MAIN_BATCH, batch_size=MAIN_BATCH, append_observables=True)  # warm-up
    torch.cuda.synchronize()
    kernel.reset_launch_counts()
    t0 = time.perf_counter()
    out = sampler.sample(MAIN_SHOTS, batch_size=MAIN_BATCH, append_observables=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernel.launch_counts)
    check_launched("d5", launches, ["wide", "small"])
    n_out = reference.program.num_outputs
    if out.shape != (MAIN_SHOTS, n_out) or out.dtype != np.bool_:
        fail(f"d5: expected ({MAIN_SHOTS}, {n_out}) bool samples, got {out.shape} {out.dtype}")
    dev_norm = sampler.last_norm_deviation
    print(f"d5: max norm deviation {dev_norm:.3e} (limit {NORM_TOL}); {MAIN_SHOTS} shots in {wall:.3f} s "
          f"= {MAIN_SHOTS / wall:.0f} shots/s (batch {MAIN_BATCH})", flush=True)
    if not (math.isfinite(dev_norm) and dev_norm <= NORM_TOL):
        fail("d5: norm deviation above the f32 tolerance")
    check_means("d5", out, reference)
    return launches


SURFACE_P = 1e-3
SURFACE_SHOTS = 4 * MAIN_BATCH
SURFACE_Z_BOUND = 5.0  # phase 21: means against the DEM's exact marginals
ROUTE_SHOTS = MAIN_BATCH  # phase 21: d5 through each route
M2D_SHOTS = 1 << 16
STATE_PROBS_TOL = 1e-5
# Phase 22: a fixed non-Clifford circuit of five qubits (T, R_Z, U3).
ORACLE_CIRCUIT = """
R 0 1 2 3 4
H 0 1 2 3 4
T 0
CNOT 0 1
R_Z(0.3) 1
U3(0.34, 0.21, 0.46) 2
CZ 1 2
T_DAG 3
CNOT 3 4
R_Z(0.7) 4
H 0 2
T 1
CNOT 2 3
U3(0.1, 0.5, 0.25) 0
M 0 1 2 3 4
"""


def surface_circuit(d: int):
    """bench_suite.py's d7 panel's noise at distance ``d``, d rounds."""
    from tsim_tpu_torch.models import rotated_surface_code_memory_z

    return rotated_surface_code_memory_z(
        d, d, after_clifford_depolarization=SURFACE_P, before_measure_flip_probability=SURFACE_P,
        after_reset_flip_probability=SURFACE_P,
    )


def dem_marginals(dem) -> np.ndarray:
    """Each detector's and observable's flip probability from the DEM's
    independent mechanisms: (1 - prod(1 - 2 p_k)) / 2 over those that touch it."""
    n_det = dem.num_detectors
    prod = np.ones(n_det + dem.num_observables)
    for ins in dem:
        if ins.type == "error":
            for t in ins.targets:
                if t.kind in ("D", "L"):
                    prod[t.val + (0 if t.kind == "D" else n_det)] *= 1 - 2 * ins.args[0]
    return (1 - prod) / 2


def all_launch_counts() -> dict:
    from tsim_tpu_torch.kernels import exact_eval, noise_draw, sample_eval

    return {**sample_eval.launch_counts, **exact_eval.launch_counts, **noise_draw.launch_counts}


def reset_all_launch_counts() -> None:
    from tsim_tpu_torch.kernels import exact_eval, noise_draw, sample_eval

    sample_eval.reset_launch_counts()
    exact_eval.reset_launch_counts()
    noise_draw.reset_launch_counts()


def surface_code_phase() -> None:
    """Phase 21: the d7 surface-code memory, compiled on the host and sampled
    through the native frame engine, checked against its DEM."""
    import hashlib

    from tsim_tpu_torch import program_io
    from tsim_tpu_torch.compile import aot_cache
    from tsim_tpu_torch.models.exported import SURFACE_D7_PROGRAM

    reference = program_io.load_npz(SURFACE_D7_PROGRAM)
    circuit = surface_circuit(7)
    aot_cache.clear_memory()  # a compile of its own
    t0 = time.perf_counter()
    sampler = circuit.compile_detector_sampler(seed=0)
    took = time.perf_counter() - t0
    compiled = program_io.ExportedProgram(program=sampler._program, noise=sampler._noise,
                                          num_detectors=sampler._num_detectors)
    bad = program_io.leaf_differences(compiled, reference)
    print(f"surface d7: compiled in {took:.3f} s ({sampler.compile_stats}) on {sampler.device}; "
          f"equal to {SURFACE_D7_PROGRAM.name}: {not bad}; route {sampler.direct_route}; {sampler!r}", flush=True)
    if bad:
        fail(f"surface d7: the compiled program differs from {SURFACE_D7_PROGRAM.name} in {bad[:8]}")
    if sampler.direct_route != "native_frame" or sampler.compile_stats["planner"] != "native":
        fail(f"surface d7: route {sampler.direct_route!r}, planner {sampler.compile_stats['planner']!r}; "
             "expected the native frame engine and the native planner")
    t0 = time.perf_counter()
    sampler._native_frame_sampler()
    print(f"surface d7: frame engine (g++ build of frame_kernels.cpp and op stream) in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    sampler.sample(SURFACE_SHOTS, separate_observables=True)  # warm-up
    torch.cuda.synchronize()
    reset_all_launch_counts()
    t0 = time.perf_counter()
    det, obs = sampler.sample(SURFACE_SHOTS, separate_observables=True)
    wall = time.perf_counter() - t0
    launches = all_launch_counts()
    print(f"surface d7: {SURFACE_SHOTS} shots in {wall:.3f} s = {SURFACE_SHOTS / wall:.0f} shots/s "
          f"(one call, separate_observables=True, host CPU {host_cpu()}, {os.cpu_count()} cores); "
          f"kernel launches {launches}", flush=True)
    if any(launches.values()):
        fail("surface d7: the fully-direct path launched kernels")
    n_det, n_obs = sampler._num_detectors, sampler._program.num_outputs - sampler._num_detectors
    if det.shape != (SURFACE_SHOTS, n_det) or obs.shape != (SURFACE_SHOTS, n_obs) or det.dtype != np.bool_:
        fail(f"surface d7: expected ({SURFACE_SHOTS}, {n_det}) and ({SURFACE_SHOTS}, {n_obs}) bool, "
             f"got {det.shape} {obs.shape} {det.dtype}")
    means = np.concatenate([det.mean(axis=0, dtype=np.float64), obs.mean(axis=0, dtype=np.float64)])
    del det, obs

    t0 = time.perf_counter()
    dem = circuit.detector_error_model()
    text = str(dem)
    dem_s = time.perf_counter() - t0
    digest = hashlib.sha256(text.encode()).hexdigest()
    print(f"surface d7: detector error model in {dem_s:.3f} s, {len(text.splitlines())} lines, "
          f"sha256 {digest}; tsim_tpu's {reference.meta['dem_sha256']}", flush=True)
    if digest != reference.meta["dem_sha256"]:
        fail("surface d7: the DEM's text differs from tsim_tpu's")
    marginal = dem_marginals(dem)
    expected = np.where(sampler._reference_sample(), 1 - marginal, marginal)
    sigma = np.sqrt(np.maximum(expected * (1 - expected), 1e-12) / SURFACE_SHOTS)
    z = np.abs(means - expected) / sigma
    worst = int(np.argmax(z))
    print(f"surface d7: means vs the DEM's marginals: max |z| {z.max():.2f} at output {worst} "
          f"(mean {means[worst]:.6f}, marginal {expected[worst]:.6f}; bound {SURFACE_Z_BOUND}); "
          f"observable mean {means[n_det:]} vs {expected[n_det:]}", flush=True)
    if not (z < SURFACE_Z_BOUND).all():
        fail("surface d7: a mean lies beyond 5 sigma of its DEM marginal")
    check_z("surface d7 vs tsim_tpu", means, SURFACE_SHOTS, reference.reference_means,
            int(reference.meta["reference_shots"]))

    c5 = surface_circuit(5)
    host = c5.compile_detector_sampler(seed=1, device="cpu")
    card = c5.compile_detector_sampler(seed=2)
    if (host.direct_route, card.direct_route) != ("host_channels", "native_frame"):
        fail(f"surface d5: routes {host.direct_route!r} and {card.direct_route!r}, expected "
             "host_channels and native_frame")
    timed = {}
    for label, s in (("host_channels", host), ("native_frame", card)):
        t0 = time.perf_counter()
        out = s.sample(ROUTE_SHOTS, append_observables=True)
        timed[label] = (out.mean(axis=0, dtype=np.float64), time.perf_counter() - t0)
    print("surface d5: " + ", ".join(f"{k} {ROUTE_SHOTS / v[1]:.0f} shots/s" for k, v in timed.items()), flush=True)
    check_z("surface d5 native_frame", timed["native_frame"][0], ROUTE_SHOTS,
            timed["host_channels"][0], ROUTE_SHOTS, ref_label="host_channels")


def m2d_and_oracle_phase() -> dict:
    """Phase 22: m2d of one native run's records equals its detector rows;
    the card's exact state probabilities of a fixed non-Clifford circuit
    against the statevector oracle."""
    from tsim_tpu_torch import Circuit
    from tsim_tpu_torch.external.vec_sim.vec_sampler import VecSampler
    from tsim_tpu_torch.stim_core.native_frame import NativeFrameSampler

    circuit = surface_circuit(7)
    records, det, obs = NativeFrameSampler(circuit.stim_circuit, seed=1).sample(M2D_SHOTS)
    t0 = time.perf_counter()
    got_det, got_obs = circuit.compile_m2d_converter().convert(measurements=records, separate_observables=True)
    same = bool(np.array_equal(got_det, det) and np.array_equal(got_obs, obs))
    print(f"m2d: {M2D_SHOTS} native records of d7 ({records.shape[1]} measurements) converted in "
          f"{time.perf_counter() - t0:.3f} s; equal to the run's detector and observable rows: {same} "
          f"({int(det.sum())} detection events)", flush=True)
    if not same or not det.any():
        fail("m2d: the converted records differ from the frame engine's detector rows")

    oracle_circuit = Circuit(ORACLE_CIRCUIT)
    oracle = VecSampler(oracle_circuit, seed=0)
    sp = oracle_circuit.compile_state_probs(seed=0)
    reset_all_launch_counts()
    worst, total = 0.0, 0.0
    for k in range(1 << oracle_circuit.num_measurements):
        bits = np.array([(k >> i) & 1 for i in range(oracle_circuit.num_measurements)], np.uint8)
        want = oracle.probability_of(bits)
        got = sp.probability_of(bits, batch_size=4)
        worst = max(worst, float(np.abs(got.astype(np.float64) - want).max()))
        total += want
    launches = {k: v for k, v in all_launch_counts().items() if v}
    print(f"state probabilities vs the statevector oracle ({oracle_circuit.num_qubits} qubits, "
          f"{1 << oracle_circuit.num_measurements} outcomes, oracle total {total:.9f}): max abs diff "
          f"{worst:.3e} (limit {STATE_PROBS_TOL}); {sp!r}; exact kernels launched {launches}", flush=True)
    if not worst <= STATE_PROBS_TOL:
        fail("state probabilities: the card disagrees with the statevector oracle")
    if not launches:
        fail("state probabilities: no exact kernel was launched")
    return launches


def ablation_path(circuit, label: str, dev) -> tuple[dict, tuple, float]:
    """Phase 13: the K8 ablation on the rung ``circuit`` at MAIN_BATCH rows.
    Returns (launches, (full ms, plain ms, bound ms, bound by, rung), max abs err)."""
    from dev.torch_kernel_ablate import ablate_rung
    from tsim_tpu_torch.compile.sample_eval import sample_product_sum_reference
    from tsim_tpu_torch.compile.sample_tables import SampleTables
    from tsim_tpu_torch.kernels import sample_eval as kernel

    x = rows(circuit.n_params, MAIN_BATCH, seed=400, device=dev)
    kernel.reset_launch_counts()
    results = ablate_rung(circuit, x)
    launches = dict(kernel.launch_counts)
    check_launched(f"ablation {label}", launches, ["ablate"])
    for r in results:
        err = "" if r["err"] is None else f", err {r['err']:.3e}"
        print(f"ablation {label} G={circuit.num_graphs}, B={MAIN_BATCH}: {r['name']:12s} {r['ms']:9.4f} ms "
              f"[{r['oracle']}{err}] -> {'ok' if r['ok'] else 'FAIL'}", flush=True)
    if not all(r["ok"] for r in results):
        fail(f"ablation {label}: a variant failed its oracle")
    t = SampleTables(circuit).to(dev)
    _, plain = timed_once(lambda: sample_product_sum_reference(t, x))
    full = next(r for r in results if r["name"] == "full")
    bound = f32_bound(circuit, 4 * t.flat.numel(), MAIN_BATCH)
    max_err = max(r["abs_err"] or 0.0 for r in results)
    return launches, (full["ms"], plain, *bound, f"{label} G={circuit.num_graphs}, full"), max_err


def approx_ablation_path(circuit, dev) -> None:
    """Phase 15: K6's stage split on the rung ``circuit`` at MAIN_BATCH rows."""
    from dev.torch_kernel_ablate import ablate_approx_rung
    from tsim_tpu_torch.kernels import exact_eval as kernel

    x = rows(circuit.n_params, MAIN_BATCH, seed=800, device=dev)
    kernel.reset_launch_counts()
    results = ablate_approx_rung(circuit, x)
    check_launched("approx ablation", dict(kernel.launch_counts), ["approx_ablate"])
    for r in results:
        print(f"approx ablation G={circuit.num_graphs}, B={MAIN_BATCH}: {r['name']:8s} {r['ms']:9.4f} ms "
              f"[{r['oracle']}] -> {'ok' if r['ok'] else 'FAIL'}", flush=True)
    if not all(r["ok"] for r in results):
        fail("approx ablation: a variant failed its oracle")


def long_row_phase(dev) -> None:
    """Phase 14: the exact kernels on rungs over 128 parameters, against the
    plain exact evaluator on the card: wide (40 graphs) and small (5), exact
    finisher bit for bit, approximate finisher within RTOL of the batch's
    largest magnitude."""
    import dataclasses

    from tsim_tpu_torch.compile.evaluate import evaluate_abs
    from tsim_tpu_torch.compile.exact_eval import evaluate_abs_exact
    from tsim_tpu_torch.compile.exact_tables import ExactTables
    from tsim_tpu_torch.compile.sample_eval import synthetic_rung
    from tsim_tpu_torch.kernels import exact_eval as kernel

    kernel.reset_launch_counts()
    for i, (n_params, graphs) in enumerate(LONG_ROW_RUNGS):
        exact = synthetic_rung(500 + i, graphs, n_params, (6, 4, 4, 2))
        factors = np.random.default_rng(600 + i).normal(size=(graphs, 2)).astype(np.float32)
        approx = dataclasses.replace(exact, prefactor=dataclasses.replace(
            exact.prefactor, approximate_floatfactors=factors, has_approximate_floatfactors=True))
        for rung in (exact, approx):
            t = ExactTables(rung).to(dev)
            name = f"{'approx' if t.approximate else 'exact'}_{kernel.configuration(t.num_graphs)}"
            x = rows(n_params, LONG_ROW_COUNT, seed=700 + i, device=dev)
            got = evaluate_abs_exact(t, x)
            want = evaluate_abs(t.circuit(), x)
            torch.cuda.synchronize()
            err = (got - want).abs()
            if t.approximate:
                # These random graph sums cancel on some rows, where only the
                # terms' size, not the row's magnitude, scales the f32 rounding.
                ok, bound = bool((err <= ATOL + RTOL * want.max()).all()), f"rtol {RTOL} of the largest row"
            else:
                ok, bound = torch.equal(got, want), "equal"
            ok = ok and bool(torch.isfinite(got).all())
            print(f"long rows: G={graphs} P={n_params} W={t.words} {name}, B={LONG_ROW_COUNT}: "
                  f"max abs err {float(err.max()):.3e}, largest row {float(want.max()):.3e} ({bound}) "
                  f"-> {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"long rows: {name} disagrees with the plain exact evaluator at P={n_params}, G={graphs}")
    check_launched("long rows", dict(kernel.launch_counts), list(kernel.KERNELS))


SHARD_Z_BOUND = 5.0  # phase 23: per-output z against phase 4's unsharded run (__graft_entry__.py:80-99)
STEP_ROWS = 1 << 16  # phase 23: rows of the low-level sharded step


def borderline_rows(tables, f, draws, border: float = 1e-4) -> torch.Tensor:
    """Rows where some rung's uniform lies within ``border`` of the
    probability it is compared with (``tests/test_torch_sampler.py``): the
    only rows two evaluations of the same draws may disagree on."""
    from tsim_tpu_torch.compile.sample_eval import evaluate_abs_sample
    from tsim_tpu_torch.ops.gf2 import static_take_columns
    from tsim_tpu_torch.sampler import _sample_component

    near = torch.zeros(f.shape[0], dtype=torch.bool, device=f.device)
    it = iter(draws)
    for comp in tables.components:
        comp_draws = [next(it) for _ in comp.rungs[1:]]
        bits, _ = _sample_component(comp, f, None, iter(comp_draws))
        noise_bits = static_take_columns(f, comp.f_selection)
        mass = evaluate_abs_sample(comp.rungs[0], noise_bits)
        for k, rung in enumerate(comp.rungs[1:]):
            x = torch.cat([noise_bits, bits[:, :k], torch.ones_like(bits[:, :1])], dim=1)
            p_one = evaluate_abs_sample(rung, x)
            near |= (comp_draws[k] - torch.clamp(p_one / mass, 0.0, 1.0)).abs() < border
            mass = torch.where(bits[:, k].bool(), p_one, mass - p_one)
    return near


def device_launches() -> dict:
    """{device: {kernel: launches}} since the counts were last set to 0."""
    from tsim_tpu_torch.kernels import exact_eval, noise_draw, sample_eval

    out = {}
    for counts in (sample_eval.device_launch_counts, exact_eval.device_launch_counts,
                   noise_draw.device_launch_counts):
        for device, per in counts.items():
            out.setdefault(device, {}).update({k: v for k, v in per.items() if v})
    return out


def sharded_phase(circuit, cultivation, random_outputs, unsharded_means, unsharded_launches: dict,
                  unsharded_rate: float) -> None:
    """Phase 23: the sharded path. A mesh over every card where there are
    two or more, else two replicas of card 0."""
    from tsim_tpu_torch.noise.device_channels import DeviceChannelSampler
    from tsim_tpu_torch.parallel.shard import ShotMesh, make_shot_mesh, sharded_sampler_step
    from tsim_tpu_torch.sampler import ProgramTables, sample_program_with_deviation

    if torch.cuda.device_count() >= 2:
        mesh, kind = make_shot_mesh(), f"every card ({torch.cuda.device_count()})"
    else:
        mesh, kind = ShotMesh(["cuda:0"] * 2), "two replicas of card 0"
    first = mesh.devices[0]
    shards_on = {str(d): mesh.devices.count(d) for d in mesh.distinct}
    print(f"sharded: mesh of {kind}: " + ", ".join(
        f"{d} ({torch.cuda.get_device_name(d)})" for d in mesh.devices), flush=True)

    # d3 f32, phase 4's call on the mesh.
    exported = circuit.load()
    sampler = circuit.compile_detector_sampler(seed=0, mesh=mesh)
    if sampler._mesh is not mesh or sampler.device != first:
        fail("sharded: the sampler does not run on the mesh it was given")
    sampler.sample(MAIN_BATCH, batch_size=MAIN_BATCH, append_observables=True)  # warm-up
    synchronize(mesh)
    reset_all_launch_counts()
    t0 = time.perf_counter()
    out = sampler.sample(MAIN_SHOTS, batch_size=MAIN_BATCH, append_observables=True)
    synchronize(mesh)
    wall = time.perf_counter() - t0
    per_device = device_launches()
    print(f"sharded d3: launches per device {per_device}", flush=True)
    for device, k in shards_on.items():
        for name in ("wide", "small"):
            want = k * unsharded_launches[name]
            if per_device.get(device, {}).get(name, 0) != want:
                fail(f"sharded d3: {name} launched {per_device.get(device, {}).get(name, 0)} times on "
                     f"{device}, expected {want} ({k} shards, each as phase 4's run)")
    if out.shape != (MAIN_SHOTS, exported.program.num_outputs) or out.dtype != np.bool_:
        fail("sharded d3: samples of the wrong shape or type")
    dev_norm = sampler.last_norm_deviation
    print(f"sharded d3: max norm deviation {dev_norm:.3e} (limit {NORM_TOL}); {MAIN_SHOTS} shots in "
          f"{wall:.3f} s = {MAIN_SHOTS / wall:.0f} shots/s on the mesh, phase 4 unsharded "
          f"{unsharded_rate:.0f} shots/s ({MAIN_SHOTS / wall / unsharded_rate:.3f}x)", flush=True)
    if not (math.isfinite(dev_norm) and dev_norm <= NORM_TOL):
        fail("sharded d3: norm deviation above the f32 tolerance")
    check_means("sharded d3", out, exported)
    means = out.mean(axis=0, dtype=np.float64)
    pooled = (means + unsharded_means) / 2
    z = np.abs(means - unsharded_means) / np.sqrt(np.maximum(pooled * (1 - pooled), 1e-12) * 2 / MAIN_SHOTS)
    print(f"sharded d3: z against phase 4's run, max {z.max():.2f} (bound {SHARD_Z_BOUND})", flush=True)
    if not z.max() < SHARD_Z_BOUND:
        fail("sharded d3: a mean disagrees with the unsharded run's beyond 5 sigma")
    del out
    sync_phase(circuit.compile_detector_sampler(seed=1, mesh=mesh), "sharded syncs")

    # The low-level step on injected noise and draw uniforms.
    tables = ProgramTables(exported.program).to(first)
    noise = DeviceChannelSampler(exported.noise, first)
    g = torch.Generator(device=first).manual_seed(23)
    f = noise.from_uniforms(torch.rand((STEP_ROWS, noise.num_channels), generator=g, device=first))
    draws = [torch.rand((STEP_ROWS,), generator=g, device=first)
             for comp in tables.components for _ in comp.rungs[1:]]
    got, dev = sharded_sampler_step(tables, mesh)(f, [None] * mesh.size, draws)
    want, _ = sample_program_with_deviation(tables, f, None, draws)
    mismatched = (got != want).any(dim=1)
    near = borderline_rows(tables, f, draws)
    cuts = [torch.tensor_split(d, mesh.size) for d in draws]
    shard_devs = [float(sample_program_with_deviation(tables, fs, None, [c[i] for c in cuts])[1][0])
                  for i, fs in enumerate(torch.tensor_split(f, mesh.size))]
    print(f"sharded step: {STEP_ROWS} rows on {mesh.size} shards: {int(mismatched.sum())} rows differ from "
          f"the whole batch's, {int(near.sum())} borderline; norm deviation {float(dev[0]):.3e}, "
          f"the shards' {' '.join(f'{d:.3e}' for d in shard_devs)}", flush=True)
    if (mismatched & ~near).any():
        fail("sharded step: rows that are not borderline differ from the whole batch's")
    if float(dev[0]) != max(shard_devs):
        fail("sharded step: the norm deviation is not the max of the shards'")
    del tables, noise, f, draws, got, want

    # Postselected 2-check cultivation, phase 10's call on the mesh.
    reset_all_launch_counts()
    postselected_path(cultivation, "sharded postselected cultivation", ["wide", "small", "self_test"],
                      random_outputs, mesh=mesh)
    per_device = device_launches()
    print(f"sharded postselected cultivation: launches per device {per_device}", flush=True)
    for device in shards_on:
        if not all(per_device.get(device, {}).get(k, 0) for k in ("wide", "small", "self_test")):
            fail(f"sharded postselected cultivation: {device} did not launch wide, small and self_test")

    # State probabilities, phase 6's call on the mesh, against the unsharded
    # estimator of the same seed.
    states = circuit.load_state_probs().replay["states"]
    sharded = circuit.compile_state_probs(seed=0, mesh=mesh)
    plain = circuit.compile_state_probs(seed=0, device=first, mesh=None)
    for sp in (sharded, plain):
        sp.probability_of(states[0], batch_size=1024)  # warm-up
    synchronize(mesh)
    reset_all_launch_counts()
    t0 = time.perf_counter()
    probs = [sharded.probability_of(s, batch_size=MAIN_BATCH) for s in states]
    wall = time.perf_counter() - t0
    per_device = device_launches()
    worst = 0.0
    for i, (s, p) in enumerate(zip(states, probs)):
        q = plain.probability_of(s, batch_size=MAIN_BATCH)
        err = np.abs(p - q)
        worst = max(worst, float((err / np.maximum(q, 1e-30)).max()))
        if p.shape != (MAIN_BATCH,) or not (err <= 1e-6 * q).all():
            fail(f"sharded state probs: state {i}: values differ from the unsharded estimator's beyond rtol 1e-6")
    print(f"sharded state probs: {len(states)} calls of {MAIN_BATCH} rows in {wall:.3f} s = "
          f"{len(states) / wall:.2f} calls/s; max rel err against unsharded {worst:.3e} (rtol 1e-6); "
          f"launches per device {per_device}", flush=True)
    for device in shards_on:
        if not all(per_device.get(device, {}).get(k, 0) for k in ("exact_small", "approx_wide")):
            fail(f"sharded state probs: {device} did not launch exact_small and approx_wide")


def grown_phase(dev, planned: dict) -> tuple[dict, dict]:
    """Phase 24: noisy 2-check grown cultivation (``cultivation_d3_grown(
    p=0.001, checks=2)``, 12 rungs up to 1084 graphs), compiled on this host
    and sampled on the card: exact mode, 2^20 shots after a warm-up batch
    (norm deviation at most 1e-5, any warning of the norm monitor fails);
    f32 mode, 4 * 2^20 shots (at most 3e-3; every output's mean within 4 *
    sqrt(2) pooled sigma of the exact run's); then the 1084-graph rung alone
    at 2^20 + 1 rows: K5 against the plain exact evaluator bit for bit (its
    partials against the plain reader of its fold, ``check_fold_partials``), K1
    against the f32 plain version within rtol 1e-5 of the row's mass, each
    timed beside its bound. Returns (exact launches, f32 launches); the two
    samplers and their rates go into ``planned`` (phase 25)."""
    import warnings

    from tsim_tpu_torch.compile.evaluate import evaluate_abs
    from tsim_tpu_torch.compile.exact_eval import evaluate_abs_exact
    from tsim_tpu_torch.compile.exact_tables import ExactTables
    from tsim_tpu_torch.compile.sample_eval import sample_product_sum_reference
    from tsim_tpu_torch.compile.sample_tables import SampleTables
    from tsim_tpu_torch.kernels import exact_eval as exact_kernel
    from tsim_tpu_torch.kernels import sample_eval as kernel
    from tsim_tpu_torch.models import cultivation_d3_grown

    circuit = cultivation_d3_grown(p=0.001, checks=2)
    t0 = time.perf_counter()
    exact = circuit.compile_detector_sampler(seed=0, evaluation="exact")
    took = time.perf_counter() - t0
    rungs = exact._program.components[0].compiled_scalar_graphs
    print(f"grown: compiled on this host ({host_cpu()}) in {took:.3f} s ({exact.compile_stats}); "
          f"rungs G = {[c.num_graphs for c in rungs]}, P = {rungs[0].n_params} to {rungs[-1].n_params}",
          flush=True)
    if exact.compile_stats["planner"] != "native":
        fail(f"grown: not planned by the native engine alone ({exact.compile_stats['planner']!r})")

    def sample(sampler, shots, label):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            try:
                out = sampler.sample(shots, batch_size=MAIN_BATCH)
            except Warning as w:
                fail(f"{label}: the norm monitor warned: {w}")
        torch.cuda.synchronize()
        return out

    def all_counts():
        return {**dict(kernel.launch_counts), **dict(exact_kernel.launch_counts)}

    runs = {}
    for mode, seed, shots, tol, kernels in (
        ("exact", 0, MAIN_BATCH, EXACT_NORM_TOL, ["exact_wide", "exact_small"]),
        ("f32", 1, GROWN_SHOTS, NORM_TOL, ["wide", "small"]),
    ):
        sampler = exact if mode == "exact" else circuit.compile_detector_sampler(seed=seed)
        sample(sampler, MAIN_BATCH, f"grown {mode} warm-up")
        kernel.reset_launch_counts()
        exact_kernel.reset_launch_counts()
        t0 = time.perf_counter()
        out = sample(sampler, shots, f"grown {mode}")
        wall = time.perf_counter() - t0
        launches = all_counts()
        check_launched(f"grown {mode}", launches, kernels)
        dev_norm = sampler.last_norm_deviation
        print(f"grown {mode}: shape {out.shape}; max norm deviation {dev_norm:.3e} (limit {tol}); {shots} "
              f"shots in {wall:.3f} s = {shots / wall:.0f} shots/s (batch {MAIN_BATCH}); launches "
              + ", ".join(f"{k} {v}" for k, v in launches.items() if v), flush=True)
        if not (math.isfinite(dev_norm) and dev_norm <= tol):
            fail(f"grown {mode}: norm deviation above {tol}")
        runs[mode] = (out.mean(axis=0, dtype=np.float64), shots, launches)
        planned[f"grown {mode} (phase 24)"] = (sampler, shots / wall, {})
        del sampler, out
    check_z("grown f32", runs["f32"][0], runs["f32"][1], runs["exact"][0], runs["exact"][1], "the exact run")

    c = rungs[-1]
    x = rows(c.n_params, KERNEL_ROWS, seed=400, device=dev)
    t = ExactTables(c).to(dev)
    got = evaluate_abs_exact(t, x)
    want, p = timed_once(lambda: evaluate_abs(t.circuit(), x))
    if not torch.equal(got, want):
        fail(f"grown G={c.num_graphs}: exact_wide differs from the plain exact evaluator "
             f"({int((got != want).sum())} rows)")
    check_fold_partials(f"grown G={c.num_graphs}", t, x, 400)
    k1 = time_ms(lambda: exact_kernel.exact_partials(t, x))
    k2 = time_ms(lambda: exact_kernel.exact_partials(t, x))
    bound = exact_bound(c, t, KERNEL_ROWS)
    print(f"grown G={c.num_graphs} P={c.n_params}, B={KERNEL_ROWS}: exact_wide equal to the plain exact "
          f"evaluator bit for bit; bound {bound[0]:.4f} ms ({bound[1]}), kernel {k1:.4f} / {k2:.4f} ms, "
          f"plain {p:.2f} ms", flush=True)
    del t, got, want
    t = SampleTables(c).to(dev)
    got = kernel.launch(t, x, "wide")
    want, mass = sample_product_sum_reference(t, x, with_mass=True)
    err = (got - want).abs()
    if not bool((err <= ATOL + RTOL * mass[:, None]).all()):
        fail(f"grown G={c.num_graphs}: wide disagrees with the plain version beyond rtol {RTOL}")
    k1 = device_ms(lambda: kernel.launch(t, x, "wide"))
    p = time_ms(lambda: sample_product_sum_reference(t, x))
    k2 = device_ms(lambda: kernel.launch(t, x, "wide"))
    bound = f32_bound(c, 4 * t.flat.numel(), KERNEL_ROWS)
    print(f"grown G={c.num_graphs} P={c.n_params}, B={KERNEL_ROWS}: wide within rtol {RTOL} of the row's mass "
          f"(max {float((err / mass[:, None].clamp_min(1e-30)).max()):.3e}); bound {bound[0]:.4f} ms "
          f"({bound[1]}), kernel {k1:.4f} / {k2:.4f} ms (device time), plain {p:.2f} ms", flush=True)
    del t, x, got, want, mass, err
    torch.cuda.empty_cache()
    return runs["exact"][2], runs["f32"][2]


def planning_phase(planned: dict) -> None:
    """Phase 25: the batch planning of each path in ``planned`` (the samplers
    of phases 4, 7, 10, 12 and 24, not built again): the default batch and
    the model's bytes a row (``sampler._peak_bytes_per_sample``); one batch
    of that size by default, whose peak device memory above what was
    allocated before (the tables) must be at most the model's bytes times
    its rows; then ``PLAN_CALLS`` calls of 4 default batches (at least
    4 * 2^20 shots) by default and at ``batch_size=2**20``, in turns, shots/s
    of each beside the phase's own 2^20 rate."""
    for label, (sampler, phase_rate, kw) in planned.items():
        post = "postselection_mask" in kw
        batch = sampler._estimate_batch_size(postselected=post)
        model = sampler._peak_bytes_per_sample(sampler.device, postselected=post)
        # The eager batch, then (plain loop) the call that captures the step.
        sampler._drop_graphs()
        for way in ("eager", "captured") if not post else ("eager",):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            base_requested = torch.cuda.memory_stats()["requested_bytes.all.current"]
            torch.cuda.reset_peak_memory_stats()
            sampler.sample(batch, **kw)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            requested = torch.cuda.memory_stats()["requested_bytes.all.peak"] - base_requested
            steps = "" if post else f", steps {sampler.last_batch_steps}"
            print(f"planning {label}: default batch {batch} rows, modelled {model} bytes a row "
                  f"({model * batch / 2**30:.3f} GiB); one default batch ({way}{steps}): peak {peak} bytes "
                  f"above the {base} allocated before ({peak / batch:.1f} a row; requested {requested}), "
                  f"measured / modelled {peak / (model * batch):.3f}", flush=True)
            if peak > model * batch:
                fail(f"planning {label}: a default batch of {batch} rows held {peak} bytes, above the "
                     f"model's {model} a row ({model * batch})")
        shots = 4 * max(batch, MAIN_BATCH)
        rates = {"default": [], "2^20": []}
        for way in ("default", "2^20", "2^20", "default") * (PLAN_CALLS // 2):
            t0 = time.perf_counter()
            sampler.sample(shots, batch_size=None if way == "default" else MAIN_BATCH, **kw)
            torch.cuda.synchronize()
            rates[way].append(shots / (time.perf_counter() - t0))
        print(f"planning {label}: {shots} shots, shots/s by default "
              + " / ".join(f"{r:.0f}" for r in rates["default"]) + ", at batch 2^20 "
              + " / ".join(f"{r:.0f}" for r in rates["2^20"])
              + f" (the phase's own at 2^20: {phase_rate:.0f})", flush=True)


def noise_draw_phase(circuit, planned: dict) -> dict:
    """Phase 26: the noise-draw kernel against the plain draw on 2^20 rows of
    seeded uniforms, bit for bit, on the noise of every listed program;
    timed beside the bound. Returns d3's (ms, plain ms, bound ms, bound by,
    label) and the largest difference (0 where every bit is equal)."""
    from tsim_tpu_torch.kernels import build
    from tsim_tpu_torch.models.exported import SURFACE_D7_PROGRAM, cultivation_d3, distillation_d5
    from tsim_tpu_torch.noise.device_channels import DeviceChannelSampler
    from tsim_tpu_torch.program_io import load_npz

    noises = {
        "d3": circuit.load().noise,
        "d3 state probs": circuit.load_state_probs().noise,
        "1-check": cultivation_d3(p=0.001, checks=1).load().noise,
        "2-check": cultivation_d3(p=0.001, checks=2).load().noise,
        "d5": distillation_d5(p=0.02).load().noise,
        "grown": planned["grown f32 (phase 24)"][0]._noise,
        "d7 surface": load_npz(SURFACE_D7_PROGRAM).noise,
    }
    timing = None
    for i, (label, noise) in enumerate(noises.items()):
        sampler = DeviceChannelSampler(noise, DEVICE)
        C, F = sampler.num_channels, sampler.num_f
        g = torch.Generator(device=DEVICE).manual_seed(260 + i)
        u = torch.rand((MAIN_BATCH, C), generator=g, device=DEVICE)

        def plain():
            return torch.cat([sampler.sample_from_uniforms(c) for c in torch.split(u, NOISE_SLICE)])

        got = sampler.from_uniforms(u)
        want = plain()
        torch.cuda.synchronize()
        differ = int((got != want).any(dim=1).sum())
        k1 = device_ms(lambda: sampler.from_uniforms(u))
        p = time_ms(plain, reps=2)
        k2 = device_ms(lambda: sampler.from_uniforms(u))
        bound = (4 * C + F) * MAIN_BATCH / HBM_BYTES_PER_S * 1e3
        print(f"noise draw {label}: C={C} F={F} W={sampler.words} N={sampler.cdf_entries}, table "
              f"{sampler.table.nbytes} bytes, B={MAIN_BATCH}: "
              f"{differ} rows differ; bound {bound:.4f} ms (bytes), kernel {k1:.4f} / {k2:.4f} ms "
              f"(device time), plain {p:.3f} ms", flush=True)
        if got.shape != (MAIN_BATCH, F) or got.dtype != torch.uint8 or differ:
            fail(f"noise draw {label}: the kernel differs from the plain draw")
        if label == "d3":
            timing = ((k1 + k2) / 2, p, bound, "bytes", f"d3 noise, B={MAIN_BATCH}")
        del sampler, u, got, want
        torch.cuda.empty_cache()
    return timing


GRAPH_BATCHES = 4  # phase 27: batches of 2^20 a call


def enqueue_ms(fn, reps: int = 5) -> float:
    """Mean host milliseconds to enqueue ``fn()``, the card idle before each."""
    took = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        took.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e3 * sum(took) / reps


def graph_phase(circuit, planned: dict) -> None:
    """Phase 27: the graphed batch step against the eager steps, on the
    samplers of phases 4, 12, 7 and 24 and on sharded d3."""
    import collections

    import tsim_tpu_torch.sampler as port
    from tsim_tpu_torch.kernels import noise_draw
    from tsim_tpu_torch.parallel.shard import ShotMesh, make_shot_mesh, shard_sizes
    from tsim_tpu_torch.utils import profiling

    if torch.cuda.device_count() >= 2:
        mesh, kind = make_shot_mesh(), f"every card ({torch.cuda.device_count()})"
    else:
        mesh, kind = ShotMesh(["cuda:0"] * 2), "two replicas of card 0"
    paths = [(label, planned[key][0]) for label, key in (
        ("d3 f32", "d3 f32 (phase 4)"), ("1-check f32", "1-check f32 (phase 12)"),
        ("2-check exact", "2-check exact (phase 7)"), ("grown f32", "grown f32 (phase 24)"))]
    paths.append((f"sharded d3 ({kind})", circuit.compile_detector_sampler(seed=0, mesh=mesh)))
    shots = GRAPH_BATCHES * MAIN_BATCH
    for label, sampler in paths:
        sampler._drop_graphs()  # a call that warms the step up and captures it
        synchronize(sampler._mesh)
        t0 = time.perf_counter()
        profiling.start()
        try:
            sampler.sample(2 * MAIN_BATCH, batch_size=MAIN_BATCH)
        finally:
            spans = profiling.stop()
        synchronize(sampler._mesh)
        first_wall = time.perf_counter() - t0
        shards = sampler._shards_for(MAIN_BATCH)
        capture_ms = [(s.end_ns - s.start_ns) / 1e6 for s in spans if s.name == "tsim.capture"]
        sizes = shard_sizes(MAIN_BATCH, len(shards))
        synchronize(sampler._mesh)
        states = [s.generator.get_state() for s in shards]
        noise_draw.reset_launch_counts()
        got = sampler._sample_batches(shots, MAIN_BATCH)
        synchronize(sampler._mesh)
        steps, graphed_dev = sampler.last_batch_steps, sampler.last_norm_deviation
        launched = noise_draw.launch_counts["noise_draw"]
        for s, state in zip(shards, states):
            s.generator.set_state(state)
        outs, devs = [], []
        for _ in range(GRAPH_BATCHES):
            for s, n in zip(shards, sizes):
                out, dev = sampler._sample_batch(n, shard=s)
                outs.append(out.cpu().numpy())
                devs.append(float(dev[0]))
        want = np.concatenate(outs).astype(np.bool_)
        differ = int((got != want).any(axis=1).sum())
        # The same call graphed and eagerly (graphs switched off), in turns.
        rates, graphs_on = {True: [], False: []}, port._graphs_on
        for graphed in (True, False, False, True):
            port._graphs_on = graphs_on if graphed else (lambda device: False)
            try:
                synchronize(sampler._mesh)
                t0 = time.perf_counter()
                sampler._sample_batches(shots, MAIN_BATCH)
                synchronize(sampler._mesh)
                rates[graphed].append(shots / (time.perf_counter() - t0))
            finally:
                port._graphs_on = graphs_on
            if not graphed:
                eager_steps = sampler.last_batch_steps
        replay_ms = enqueue_ms(lambda: [sampler._batch_step(s, n, collections.Counter(), True, shards)
                                        for s, n in zip(shards, sizes)])
        eager_ms = enqueue_ms(lambda: [sampler._sample_batch(n, shard=s) for s, n in zip(shards, sizes)])
        print(f"graphed {label}: {shots} shots, {len(shards)} shard(s); {differ} rows differ from the eager "
              f"steps, norm deviation {graphed_dev:.6e} (eager steps' {max(devs):.6e}); steps a call "
              f"graphed {steps}, eager {eager_steps}; noise_draw launched {launched}; shots/s in turns "
              f"graphed {' / '.join(f'{r:.0f}' for r in rates[True])}, eager "
              f"{' / '.join(f'{r:.0f}' for r in rates[False])}; host enqueue a batch (every "
              f"shard) replayed {replay_ms:.4f} ms, eager {eager_ms:.4f} ms; capture "
              + " / ".join(f"{ms:.2f}" for ms in capture_ms) + f" ms a shard, the call of an eager batch "
              f"and a captured one {1e3 * first_wall:.1f} ms", flush=True)
        if got.shape != want.shape or differ or graphed_dev != max(devs):
            fail(f"graphed {label}: the graphed call differs from the eager steps")
        if steps != {"eager": 0, "capture": 0, "replay": GRAPH_BATCHES * len(shards)}:
            fail(f"graphed {label}: expected every batch replayed, got {steps}")
        if launched != GRAPH_BATCHES * len(shards):
            fail(f"graphed {label}: the noise kernel launched {launched} times, expected one a shard and batch")


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check runs only on a CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device 0: {kind}", flush=True)
    # The plain version's parity matmul stays in full f32 (0/1 inputs are
    # exact in TF32 too, but the reference states its precision).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from tsim_tpu_torch.compile.sample_eval import sample_product_sum_reference
    from tsim_tpu_torch.compile.sample_tables import SampleTables
    from tsim_tpu_torch.kernels import build
    from tsim_tpu_torch.kernels import noise_draw as noise_kernel
    from tsim_tpu_torch.kernels import sample_eval as kernel
    from tsim_tpu_torch.models.exported import distillation_d3, distillation_d5

    # ---- phase 2: build -------------------------------------------------
    t0 = time.perf_counter()
    lib_path = build.build()
    build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib_path}", flush=True)
    for line in (lib_path.parent / "ptxas.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # ---- phase 3: kernel vs plain version -------------------------------
    circuit = distillation_d3(p=0.05)
    exported = circuit.load()
    rungs = exported.program.components[0].compiled_scalar_graphs
    dev = torch.device("cuda")
    tables = [SampleTables(c).to(dev) for c in rungs]
    max_abs = {"wide": 0.0, "small": 0.0}
    timing = {}
    timed = {"wide": 103, "small": 6}  # graphs of the rung timed per configuration
    for i, t in enumerate(tables):
        x = rows(t.n_params, KERNEL_ROWS, seed=100 + i, device=dev)
        got = kernel.sample_product_sum(t, x)
        want = sample_product_sum_reference(t, x)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail(f"rung {i}: kernel output is not finite")
        err = (got - want).abs()
        scale = want.norm(dim=1, keepdim=True)
        rel = float((err / scale.clamp_min(1e-30)).max())
        ok = bool((err <= ATOL + RTOL * scale).all())
        config = kernel.configuration(t.num_graphs)
        max_abs[config] = max(max_abs[config], float(err.max()))
        print(
            f"rung {i}: G={t.num_graphs} P={t.n_params} {config}, B={KERNEL_ROWS}: "
            f"max rel err {rel:.3e}, max abs err {float(err.max()):.3e} -> {'ok' if ok else 'FAIL'}",
            flush=True,
        )
        if not ok:
            fail(f"rung {i}: kernel disagrees with the plain version beyond rtol {RTOL}")
        del got, want, err, scale
        if timed[config] == t.num_graphs and config not in timing:
            k1 = device_ms(lambda: kernel.sample_product_sum(t, x))
            p1 = time_ms(lambda: sample_product_sum_reference(t, x))
            k2 = device_ms(lambda: kernel.sample_product_sum(t, x))
            p2 = time_ms(lambda: sample_product_sum_reference(t, x))
            bound = f32_bound(rungs[i], 4 * t.flat.numel(), KERNEL_ROWS)
            timing[config] = ((k1 + k2) / 2, (p1 + p2) / 2, *bound, f"d3 G={t.num_graphs}")
            print(
                f"time at B={KERNEL_ROWS}, G={t.num_graphs} ({config}): bound {bound[0]:.4f} ms "
                f"({bound[1]}), kernel {k1:.4f} / {k2:.4f} ms (device time), plain {p1:.4f} / {p2:.4f} ms",
                flush=True,
            )
    if set(timing) != set(timed):
        fail(f"no rung with the timed graph counts {timed}")
    del tables
    torch.cuda.empty_cache()

    # ---- phase 4: the main path -----------------------------------------
    sampler = circuit.compile_detector_sampler(seed=0, device="cuda")
    sampler.sample(MAIN_BATCH, batch_size=MAIN_BATCH, append_observables=True)  # warm-up
    torch.cuda.synchronize()
    kernel.reset_launch_counts()
    noise_kernel.reset_launch_counts()
    t0 = time.perf_counter()
    out = sampler.sample(MAIN_SHOTS, batch_size=MAIN_BATCH, append_observables=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernel.launch_counts)
    main_noise_launches = noise_kernel.launch_counts["noise_draw"]
    print(f"slice: noise_draw launches {main_noise_launches}; batch steps {sampler.last_batch_steps}", flush=True)
    if main_noise_launches <= 0:
        fail("slice: the noise-draw kernel of the path was not launched")
    n_out = exported.program.num_outputs
    print(f"slice: shape {out.shape}, dtype {out.dtype}", flush=True)
    if out.shape != (MAIN_SHOTS, n_out) or out.dtype != np.bool_:
        fail(f"expected ({MAIN_SHOTS}, {n_out}) bool samples")
    dev_norm = sampler.last_norm_deviation
    print(f"slice: max norm deviation {dev_norm:.3e} (limit {NORM_TOL})", flush=True)
    if not (math.isfinite(dev_norm) and dev_norm <= NORM_TOL):
        fail("norm deviation above the f32 tolerance")
    check_launched("slice", launches, ["wide", "small"])
    print(
        f"slice: {MAIN_SHOTS} shots in {wall:.3f} s = {MAIN_SHOTS / wall:.0f} shots/s "
        f"(batch {MAIN_BATCH}, {kind})",
        flush=True,
    )

    check_means("slice", out, exported)
    main_means, main_rate = out.mean(axis=0, dtype=np.float64), MAIN_SHOTS / wall
    # (sampler, its phase's shots/s at batches of 2^20, its call's options) of each path phase 25 plans
    planned = {"d3 f32 (phase 4)": (sampler, main_rate, {"append_observables": True})}
    del sampler, out
    torch.cuda.empty_cache()

    # ---- phase 5: exact kernels vs plain exact evaluator ----------------
    from tsim_tpu_torch.models.exported import cultivation_d3

    cultivation = cultivation_d3(p=0.001, checks=2)
    exact_err, exact_timing, as_exact = exact_kernel_phase(
        {
            "cultivation": cultivation.load(),
            "d3": exported,
            "d3_state_probs": circuit.load_state_probs(),
        },
        dev,
    )
    path_rows_time(circuit)

    # ---- phase 6: state probabilities -----------------------------------
    paths = [state_probs_path(circuit)]

    # ---- phase 7: exact-mode sampling -----------------------------------
    paths += exact_sampling_path(cultivation, circuit, planned)
    exact_launches = {k: sum(p[k] for p in paths) for k in exact_err}

    # ---- phase 8: per-term kernels vs plain version ----------------------
    cultivation_checks1 = cultivation_d3(p=0.001, checks=1)
    per_term_err, per_term_timing = per_term_phase(
        {"d3": exported, "cultivation_checks1": cultivation_checks1.load(), "cultivation": cultivation.load(),
         "d5": distillation_d5(p=0.02).load()},
        dev,
    )

    # ---- phase 9: the self-test ------------------------------------------
    self_test_err, self_test_timing = self_test_phase(dev)

    # ---- phases 10 and 11: postselected f32 cultivation ------------------
    f32_paths = [launches]
    random_outputs = reference_fold(cultivation)
    packed = postselected_path(
        cultivation, "postselected cultivation", ["wide", "small", "self_test"], random_outputs, planned=planned
    )
    if packed["per_term_wide"] or packed["per_term_small"]:
        fail("postselected cultivation: the packed path launched per-term kernels")
    f32_paths.append(packed)
    per_term = postselected_path(
        cultivation, "postselected cultivation, per-term", ["per_term_wide", "per_term_small"],
        random_outputs, per_term=True,
    )
    if per_term["wide"] or per_term["small"]:
        fail("postselected cultivation, per-term: packed kernels were launched")
    f32_paths.append(per_term)

    # ---- phase 12: 1-check cultivation in f32 mode -----------------------
    f32_paths.append(checks1_path(cultivation_checks1, planned))

    # ---- phase 13: the stage ablation ------------------------------------
    ablate_launches, ablate_timing, ablate_err = ablation_path(
        cultivation.load().program.components[0].compiled_scalar_graphs[-1], "cultivation", dev)
    more_launches, _, more_err = ablation_path(
        cultivation_checks1.load().program.components[0].compiled_scalar_graphs[-1],
        "cultivation 1-check", dev)
    ablate_launches = {k: ablate_launches[k] + more_launches[k] for k in ablate_launches}
    ablate_err = max(ablate_err, more_err)

    # ---- phase 14: the exact kernels past 128 parameters ------------------
    long_row_phase(dev)

    # ---- phase 15: the stage split of the wide approximate kernel --------
    approx_ablation_path(circuit.load_state_probs().program.components[0].compiled_scalar_graphs[1], dev)

    # ---- phase 16: small batches -----------------------------------------
    f32_paths.append(small_batch_path(circuit))

    # ---- phase 17: host synchronisations of the batch loop ---------------
    sync_phase(circuit.compile_detector_sampler(seed=1, device=DEVICE))

    # ---- phase 18: checkpointing -----------------------------------------
    checkpoint_phase(circuit)

    # ---- phase 19: the host compile path ---------------------------------
    host_compile_phase()

    # ---- phase 20: d5 distillation, compiled here and sampled on the card -
    f32_paths.append(d5_path())
    f32_launches = {k: sum(p[k] for p in f32_paths) for k in kernel.launch_counts}

    # ---- phase 21: the d7 surface code on the native frame engine --------
    surface_code_phase()

    # ---- phase 22: m2d and the statevector oracle ------------------------
    oracle_launches = m2d_and_oracle_phase()
    exact_launches = {k: exact_launches[k] + oracle_launches.get(k, 0) for k in exact_launches}

    # ---- phase 23: the sharded path ---------------------------------------
    sharded_phase(circuit, cultivation, random_outputs, main_means, launches, main_rate)

    # ---- phase 24: noisy grown cultivation ---------------------------------
    grown_exact, grown_f32 = grown_phase(dev, planned)
    exact_launches = {k: exact_launches[k] + grown_exact.get(k, 0) for k in exact_launches}
    f32_launches = {k: f32_launches[k] + grown_f32.get(k, 0) for k in f32_launches}

    # ---- phase 25: batch planning ------------------------------------------
    planning_phase(planned)

    # ---- phase 26: the noise-draw kernel -----------------------------------
    noise_timing = noise_draw_phase(circuit, planned)

    # ---- phase 27: the graphed batch step ------------------------------------
    graph_phase(circuit, planned)

    def entry(name, source, replaces, n_launches, err, timed):
        ms, plain_ms, bound_ms, bound_by, rung = timed
        if ms < bound_ms:
            fail(f"{name}: {ms:.4f} ms on {rung} is below its bound of {bound_ms:.4f} ms: "
                 "the bound or the timing is at fault")
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": n_launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None, "rung": rung,
        }

    entries = [
        entry(f"sample_eval_{c}", SOURCE, REPLACES[c], f32_launches[c],
              max(max_abs[c], per_term_err[c]), timing[c])
        for c in ("wide", "small")
    ]
    entries.append(entry("sample_eval_wide_32", SOURCE, REPLACES["wide"], f32_launches["wide_32"],
                         per_term_err["wide_32"], per_term_timing["wide_32"]))
    entries.append(entry("sample_eval_per_term_wide_32", SOURCE, PER_TERM_REPLACES["per_term_wide"],
                         f32_launches["per_term_wide_32"], per_term_err["per_term_wide_32"],
                         per_term_timing["per_term_wide_32"]))
    entries += [
        entry(f"sample_eval_{c}", SOURCE, PER_TERM_REPLACES[c], f32_launches[c], per_term_err[c],
              per_term_timing[c])
        for c in PER_TERM_REPLACES
    ]
    entries.append(entry("sample_eval_self_test", SOURCE, SELF_TEST_REPLACES, f32_launches["self_test"],
                         self_test_err, self_test_timing))
    entries += [
        entry(name, EXACT_SOURCE, EXACT_REPLACES[name], exact_launches[name], exact_err[name],
              exact_timing[name])
        for name in EXACT_REPLACES
    ]
    for e in entries:  # the approximate finisher's bound as the exact one's is counted, beside its own
        if e["name"] in as_exact:
            e["bound_ms_as_exact"] = as_exact[e["name"]]
    entries.append(entry("sample_eval_ablate", SOURCE, ABLATE_REPLACES, ablate_launches["ablate"],
                         ablate_err, ablate_timing))
    entries.append(entry("noise_draw", NOISE_SOURCE, NOISE_REPLACES, main_noise_launches, 0.0, noise_timing))
    print(f"packed vs per-term on the timed rungs: " + ", ".join(
        f"{c} {per_term_timing[c][0]:.4f} ms ({per_term_timing[c][4]})" for c in per_term_timing), flush=True)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
