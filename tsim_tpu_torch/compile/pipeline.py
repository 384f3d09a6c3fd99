"""Compilation pipeline: prepared graph -> executable sampling program.

Stage two of compilation (reference ``tsim/compile/pipeline.py``): split the
prepared graph into connected components, classify direct components, plug
outputs per mode, stabilizer-decompose, compile term tensors.
"""

from __future__ import annotations

from typing import Literal

import numpy as np

from ..core.graph_prep import (
    ConnectedComponent,
    classify_direct,
    connected_components,
    get_params,
)
from ..core.types import SamplingGraph
from ..program_io import CompiledComponent, CompiledProgram, CompiledScalarGraphs
from ..zx.graph import ZXGraph
from ..zx.simplify import full_reduce
from .compile import compile_scalar_graphs
from .stabrank import DecompositionBudgetExceeded, find_stab

DecompositionMode = Literal["sequential", "joint"]
DecompositionStrategy = Literal["cat5", "bss", "cutting"]

# Term count above which a planner-declined component is re-raced with the
# BSS fallback. Flagship workloads (d3/d5 distillation, 1-check cultivation)
# compile well under this, so they never pay the extra variants.
_BSS_RETRY_THRESHOLD = 512

# Absolute per-variant term cap while a better variant may still exist.
# Without it the FIRST variant runs unbounded (max_terms=None), so one
# planner-declined heavy rung can hit the raw 2^(T/2) pair recursion and
# burn hours/EBs before a later variant would have found a small cover
# (seen on the full-protocol cultivation ladder: tcount ~54 rungs stuck
# >15 min at 8 GB). If EVERY variant aborts on this cap, the leading
# variant alone is retried unbounded, preserving completeness.
_ABS_MAX_TERMS = 8192

# Heavy-regime threshold for race thinning: once a rung's winning count
# reaches this, re-racing every variant on every subsequent rung costs more
# than it saves (losing variants burn their full abort budget), so the race
# thins to the streak leader with a periodic full re-race.
_THIN_THRESHOLD = 256
_THIN_RERACE_EVERY = 4

_COMPILE_DEBUG = __import__("os").environ.get("TSIM_TPU_COMPILE_DEBUG", "") == "1"


def _debug(msg: str) -> None:
    if _COMPILE_DEBUG:
        print(f"[tsim-tpu compile] {msg}", flush=True)


def compile_program(
    prepared: SamplingGraph,
    *,
    mode: DecompositionMode,
    strategy: DecompositionStrategy = "cat5",
) -> CompiledProgram:
    components = connected_components(prepared.graph)
    f_indices_global = _get_f_indices(prepared.graph)
    num_outputs = prepared.num_outputs

    direct_entries: list[tuple[int, int, bool]] = []
    compiled_components: list[CompiledComponent] = []
    compiled_output_order: list[int] = []

    for component in sorted(components, key=lambda c: len(c.output_indices)):
        direct = classify_direct(component)
        if direct is not None:
            f_idx, flip = direct
            direct_entries.append((component.output_indices[0], f_idx, flip))
        else:
            compiled_components.append(
                _compile_component(
                    component=component,
                    f_indices_global=f_indices_global,
                    mode=mode,
                    strategy=strategy,
                )
            )
            compiled_output_order.extend(component.output_indices)

    direct_entries.sort()
    direct_output_order = [e[0] for e in direct_entries]
    # Constants (classify_direct -> f_idx -1) read dummy column 0 and are
    # masked out of the gather.
    direct_const_mask = [e[1] < 0 for e in direct_entries]
    direct_f_indices = [max(e[1], 0) for e in direct_entries]
    direct_flips = [e[2] for e in direct_entries]

    output_order = np.array(direct_output_order + compiled_output_order, dtype=np.int32)
    reindex = np.argsort(output_order)
    is_identity = np.array_equal(reindex, np.arange(len(output_order)))

    return CompiledProgram(
        components=tuple(compiled_components),
        direct_f_indices=np.array(direct_f_indices, dtype=np.int32),
        direct_flips=np.array(direct_flips, dtype=np.bool_),
        direct_const_mask=np.array(direct_const_mask, dtype=np.bool_),
        output_order=output_order,
        output_reindex=None if is_identity else reindex.astype(np.int32),
        num_outputs=num_outputs,
        num_detectors=prepared.num_detectors,
    )


def _get_f_indices(graph: ZXGraph) -> list[int]:
    return sorted(
        int(p[1:]) for p in get_params(graph) if isinstance(p, str) and p.startswith("f")
    )


def _remove_phase_terms(graph: ZXGraph) -> None:
    """Drop parametrized global-phase terms (irrelevant pre-decomposition)."""
    graph.scalar.phasevars_halfpi = {}
    graph.scalar.phasevars_pi_pair = []


def _compile_component(
    component: ConnectedComponent,
    f_indices_global: list[int],
    mode: DecompositionMode,
    strategy: DecompositionStrategy = "cat5",
) -> CompiledComponent:
    graph = component.graph
    output_indices = component.output_indices
    num_component_outputs = len(graph.outputs())

    component_f_set = set(_get_f_indices(graph))
    f_selection = [i for i, fi in enumerate(f_indices_global) if fi in component_f_set]
    f_selected_values = [f_indices_global[i] for i in f_selection]

    outputs_to_plug = (
        list(range(num_component_outputs + 1))
        if mode == "sequential"
        else [0, num_component_outputs]
    )

    component_m_chars = [f"m{i}" for i in output_indices]
    plugged_graphs = _plug_outputs(graph, component_m_chars, outputs_to_plug)

    compiled_graphs: list[CompiledScalarGraphs] = []
    power2_base: int | None = None
    # Variant order carries across rungs: neighboring rungs of a ladder
    # decompose alike, so the previous rung's winner runs first and seeds a
    # tight budget that makes this rung's losing variants abort cheaply.
    # Variants are (shake, pi_hub, drop_penalty): the planner's drop
    # penalty (see zx.decompose._PLAN_DROP_PENALTY) joins the race only on
    # heavy rungs, where the all-kept/low-rank matching trade-off actually
    # bites (light circuits never pay for the extra variant).
    variant_order = [
        (True, True, 1.0),
        (False, True, 1.0),
        (True, False, 1.0),
        (False, False, 1.0),
    ]

    from ..zx.simplify import set_shake

    # Race thinning (heavy ladders): when the leading variant has won
    # consecutive rungs and counts are in the heavy regime, run only the
    # leader and re-race the full field every few rungs. On the grown-
    # cultivation ladder a full race per heavy rung costs 4-8 losing
    # variants x their abort budget, for a winner the leader predicts
    # almost every time.
    leader_streak = 0
    rungs_since_race = 0
    prev_count: int | None = None

    for num_m_plugged, plugged in zip(outputs_to_plug, plugged_graphs):
        param_names = [f"f{i}" for i in f_selected_values]
        param_names += [f"m{output_indices[j]}" for j in range(num_m_plugged)]
        reduced_cache: dict = {}

        # The shake pass and pi-hub normalization are heuristics that
        # shrink some decompositions and grow others: compile the variants,
        # keep the smallest term count.
        from ..zx.decompose import (
            set_pi_hub_normalize,
            set_plan_drop_penalty,
            set_t_fallback,
        )

        best_list = None
        best_base = None
        best_variant = None
        heavy = prev_count is not None and prev_count >= _THIN_THRESHOLD
        thin = (
            leader_streak >= 2
            and heavy
            and rungs_since_race < _THIN_RERACE_EVERY
        )
        race_order = list(variant_order)
        if heavy and not thin:
            # Race the leader under the alternate drop penalty too: on
            # heavy rungs a low-rank matching with filter-dropped pairs
            # can recurse to far fewer terms than the all-kept higher-rank
            # plan (and vice versa) — measured both ways on the grown-
            # cultivation ladder.
            s0, p0, w0 = race_order[0]
            alt = (s0, p0, 0.375 if w0 == 1.0 else 1.0)
            if alt not in race_order:
                race_order.append(alt)
        pair_variants = [(s, p, w, "pair") for s, p, w in race_order]
        bss_variants = [(s, p, w, "bss") for s, p, w, _ in pair_variants]
        first_variants = pair_variants[:1] if thin else pair_variants
        # Iterative-deepening race. Caps escalate only while no variant has
        # landed, so planner-covered variants win in seconds while a
        # planner-declined heavy rung's exponential 2^(T/2) pair recursion
        # aborts early instead of running unbounded (the abort fires at a
        # working set of 4x the cap; a set that large costs that many ZX
        # reductions, so small caps keep losing variants cheap). The BSS
        # 6->7 rounds (7^(T/6)) run when the pair round's best is still
        # above _BSS_RETRY_THRESHOLD (capped then by the pair best itself,
        # so a genuinely smaller BSS decomposition can land) — budget
        # aborts correlate with exactly the large planner-declined
        # components the retry targets, so they also run when the pair
        # round found nothing at all. The final round retries the leading
        # variant unbounded, so pathological rungs compile (slowly) rather
        # than fail.
        # Neighboring rungs decompose alike: ramp the first-round cap with
        # the previous rung's count so a heavy rung lands in one pass
        # instead of abort-all-at-512 followed by a full 8192 re-race.
        first_cap = _BSS_RETRY_THRESHOLD
        if prev_count is not None:
            first_cap = max(first_cap, min(2 * prev_count, _ABS_MAX_TERMS))
        # Escalation rounds race the FULL field even when thinned: they
        # only run when every first-round variant aborted, which is
        # exactly when the thin leader is suspect. Measured on the grown-
        # cultivation full plug: the thin shake=False leader escalates to
        # 16,249 terms while the unraced shake=True variant lands 1,084 —
        # and once the small variant lands, the tight budget makes the
        # remaining escalation losers abort cheaply.
        esc_variants = pair_variants
        rounds = [
            ("first", first_variants, first_cap),
            ("bss", bss_variants, _BSS_RETRY_THRESHOLD),
            ("escalate", esc_variants, _ABS_MAX_TERMS),
            (
                "bss-escalate",
                [(s, p, w, "bss") for s, p, w, _ in esc_variants],
                _ABS_MAX_TERMS,
            ),
            ("uncapped", pair_variants[:1], None),
        ]
        for kind, round_variants, cap in rounds:
            if kind == "bss":
                # The cheap BSS race: runs whenever the pair round's best is
                # large (or absent) — budget aborts correlate with exactly
                # the planner-declined components the retry targets.
                if strategy != "cat5":
                    continue
                if thin:
                    continue
                if best_list is not None and len(best_list) <= _BSS_RETRY_THRESHOLD:
                    continue
                if best_list is not None:
                    # Race against the landed pair best, not the static
                    # threshold: a BSS decomposition genuinely smaller than
                    # a large pair best must be allowed to land.
                    cap = len(best_list)
            elif kind != "first" and best_list is not None:
                # Escalation rounds only rescue all-abort rungs: re-racing
                # against an in-budget best costs guaranteed aborts per
                # heavy rung and has never won (docs/benchmarks.md: pair ==
                # bss-first trajectories).
                continue
            elif kind == "bss-escalate" and strategy != "cat5":
                # Non-cat5 strategies have no BSS fallback to escalate to
                # (replace_magic_states honors the strategy directly).
                continue
            for shake, pi_hub, drop_pen, fallback in round_variants:
                budget = cap
                tight = best_list is not None
                if tight:
                    budget = (
                        len(best_list)
                        if budget is None
                        else min(budget, len(best_list))
                    )
                prev = set_shake(shake)
                prev_ph = set_pi_hub_normalize(pi_hub)
                prev_fb = set_t_fallback(fallback)
                prev_dp = set_plan_drop_penalty(drop_pen)
                g_list = None
                try:
                    # The pre-decomposition reduction depends only on the
                    # shake flag: share it across the pi_hub/penalty/
                    # fallback variants of this rung.
                    cached = reduced_cache.get(shake)
                    if cached is None:
                        g_red = plugged.copy()
                        full_reduce(g_red, paramSafe=True)
                        g_red.normalize()
                        base = (
                            power2_base
                            if power2_base is not None
                            else g_red.scalar.power2
                        )
                        g_red.scalar.add_power(-base)
                        _remove_phase_terms(g_red)
                        reduced_cache[shake] = (g_red, base)
                        cached = (g_red, base)
                    g_copy, base = cached[0].copy(), cached[1]
                    g_list = find_stab(
                        g_copy, strategy=strategy, max_terms=budget, tight=tight
                    )
                except DecompositionBudgetExceeded:
                    if tight:
                        _debug(
                            f"variant shake={shake} pi_hub={pi_hub}"
                            f" pen={drop_pen} kind={kind}"
                            f" aborted against best={len(best_list)}"
                        )
                finally:
                    set_shake(prev)
                    set_pi_hub_normalize(prev_ph)
                    set_t_fallback(prev_fb)
                    set_plan_drop_penalty(prev_dp)
                if g_list is not None and (
                    best_list is None or len(g_list) < len(best_list)
                ):
                    best_list = g_list
                    best_base = base
                    best_variant = (shake, pi_hub, drop_pen)
                if (
                    kind in ("escalate", "bss-escalate")
                    and best_list is not None
                    and len(best_list)
                    <= max(_BSS_RETRY_THRESHOLD, 8 * (prev_count or 0))
                ):
                    # Escalation early exit: a landed count back in the
                    # ladder's normal band (<=8x the previous rung) is
                    # almost never beaten by the remaining variants, and
                    # each of them would burn a full tight-budget abort
                    # (~25 s on the grown full plug).
                    break
        assert best_list is not None
        if best_variant == variant_order[0]:
            leader_streak += 1
        else:
            leader_streak = 0
        rungs_since_race = rungs_since_race + 1 if thin else 0
        if best_variant is not None and variant_order[0] != best_variant:
            if best_variant in variant_order:
                variant_order.remove(best_variant)
            variant_order.insert(0, best_variant)
            del variant_order[6:]
        prev_count = len(best_list)
        if power2_base is None:
            power2_base = best_base
        if len(best_list) == 1:
            _remove_phase_terms(best_list[0])
        compiled_graphs.append(compile_scalar_graphs(best_list, param_names))

    return CompiledComponent(
        output_indices=tuple(output_indices),
        f_selection=tuple(int(i) for i in f_selection),
        compiled_scalar_graphs=tuple(compiled_graphs),
    )


def _plug_outputs(
    graph: ZXGraph, m_chars: list[str], outputs_to_plug: list[int]
) -> list[ZXGraph]:
    """Plug the first k outputs with parametrized <m| effects, trace the rest."""
    graphs: list[ZXGraph] = []
    num_outputs = len(graph.outputs())
    for num_plugged in outputs_to_plug:
        g = graph.copy()
        output_vertices = list(g.outputs())
        effect = "0" * num_plugged + "+" * (num_outputs - num_plugged)
        g.apply_effect(effect)
        for i, v in enumerate(output_vertices[:num_plugged]):
            g.set_phase(v, m_chars[i])
        # '+' plugs implement the trace: compensate their 1/sqrt(2).
        g.scalar.add_power(num_outputs - num_plugged)
        graphs.append(g)
    return graphs
