"""Noisy grown cultivation (``cultivation_d3_grown``) through the port's
compiler, on the CPU.

The 2-check circuit's decompositions carry constant factors of two in the
graphs' floatfactors (up to 2^30), which the exact evaluation's int32
aligned graph sum overflowed on nine of its twelve rungs: the ladder then
mis-normalized by up to 4 (``dev/torch_check_grown_cultivation.py``).
``compile/compile.py::compile_scalar_graphs`` now moves those factors into
``power2`` where :func:`coefficient_bound` finds that int32 could
overflow, which leaves every committed program as ``tsim_tpu`` compiles it.
Here: the normalization of every rung (1- and 2-check, 4096 seeded noisy
shots, warnings as errors), each rung's prefix marginals against a
statevector oracle built on ``external/vec_sim`` under three drawn noise
configurations, the compile step's property (a rung's tables evaluate to the
sum of its graphs at nonzero f), and the noiseless circuits still equal to
``tsim_tpu``'s compile leaf for leaf. ``tsim_tpu`` keeps the fault, so no
test compares the two on the noisy circuit. One compile of the 2-check
circuit (about 50 s) serves the module.
"""

from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

from tests.test_torch_compile_parity import assert_same_leaves, port_compile, reference_compile
from tsim_tpu_torch.compile import compile as compile_module
from tsim_tpu_torch.compile import pipeline
from tsim_tpu_torch.compile.compile import INT32_LIMIT, coefficient_bound, compile_scalar_graphs
from tsim_tpu_torch.compile.evaluate import evaluate_abs
from tsim_tpu_torch.core.graph_prep import prepare_graph
from tsim_tpu_torch.core.parse import _iter_pauli_products
from tsim_tpu_torch.core.tags import is_t_tag
from tsim_tpu_torch.external.vec_sim.vec_sim import H, PAULI, SINGLE, TWO, VecSim
from tsim_tpu_torch.models import cultivation_d3_grown
from tsim_tpu_torch.sampler import CompiledDetectorSampler, compile_circuit

SHOTS = 4096
NORM_TOL = 1e-5
ORACLE_RTOL = 1e-6


def _compile(checks: int, monkeypatch, record=None):
    monkeypatch.setenv("TSIM_TPU_COMPILE_CACHE", "0")
    if record is not None:
        real = pipeline.compile_scalar_graphs

        def recording(g_list, params):
            record.append(([g.copy() for g in g_list], list(params)))
            return real(g_list, params)

        monkeypatch.setattr(pipeline, "compile_scalar_graphs", recording)
    circuit = cultivation_d3_grown(p=0.001, checks=checks)
    exported, stats = compile_circuit(circuit, sample_detectors=True, mode="sequential")
    assert stats["planner"] == "native"
    return circuit, exported


@pytest.fixture(scope="module")
def grown2():
    """(circuit, exported program, each rung's (graphs, parameter names))."""
    rungs = []
    with pytest.MonkeyPatch.context() as mp:
        circuit, exported = _compile(2, mp, rungs)
    return circuit, exported, rungs


@pytest.fixture(scope="module")
def grown1():
    with pytest.MonkeyPatch.context() as mp:
        return _compile(1, mp)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The module's evaluations are large torch operations: two threads a
    process keep the test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("checks", [1, 2])
def test_every_rung_normalizes_under_noise(checks, grown1, grown2):
    """The sampler's own monitor in exact mode, which takes every rung's
    deviation on every shot, over 4096 seeded noisy shots, with warnings as
    errors (``dev/torch_check_grown_cultivation.py`` prints it rung by rung)."""
    circuit, exported = grown1 if checks == 1 else grown2[:2]
    rungs = exported.program.components[0].compiled_scalar_graphs
    assert [r.num_graphs for r in rungs][-1] == (64 if checks == 1 else 1084)
    sampler = CompiledDetectorSampler(exported, seed=0, device="cpu", evaluation="exact")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = sampler.sample(SHOTS, batch_size=SHOTS)
    assert out.shape == (SHOTS, exported.num_detectors)
    assert sampler.last_norm_deviation <= NORM_TOL


def _graphs_value(graphs, params, row) -> float:
    """|sum of the graphs' values| at one row (the tensor oracle of a
    vertex-free graph is its scalar)."""
    from tsim_tpu_torch.zx.tensor import graphs_sum_to_tensor

    return abs(complex(graphs_sum_to_tensor(graphs, dict(zip(params, (int(b) for b in row))))))


@pytest.fixture(scope="module")
def walked_rows(grown2):
    """Per rung k >= 1, rows (f, m prefix, 0 or 1) and their graph sums: eight
    seeded f rows with f set, each walking the ladder with bits drawn from
    the rungs' own graph sums, so that every prefix is one that occurs."""
    _, _, rungs = grown2
    n_f = len(rungs[0][1])  # rung 0 takes the f-bits alone
    rng = np.random.default_rng(5)
    f = (rng.random((8, n_f)) < 0.1).astype(np.uint8)
    f[:, 0] = 1
    prefix = np.zeros((8, 0), np.uint8)
    out = {}
    for k in range(1, len(rungs)):
        graphs, params = rungs[k]
        x = np.concatenate([np.repeat(np.hstack([f, prefix]), 2, axis=0), np.tile([[0], [1]], (8, 1))], axis=1)
        x = x.astype(np.uint8)
        values = np.array([_graphs_value(graphs, params, row) for row in x])
        out[k] = (x, values)
        pairs = values.reshape(8, 2)
        bit = (rng.random(8) * pairs.sum(axis=1) < pairs[:, 1]).astype(np.uint8)
        prefix = np.hstack([prefix, bit[:, None]])
    return out


def test_compile_step_keeps_each_rung_sum_at_nonzero_f(grown2, walked_rows):
    """The step at fault: a rung's compiled tables evaluate to the sum of its
    graphs, at f-assignments with f set and prefixes that occur, and every
    rung whose tables could overflow int32 gets stripped ones that cannot."""
    _, _, rungs = grown2
    overflowing = 0
    for k, (x, want) in walked_rows.items():
        graphs, params = rungs[k]
        tables = compile_scalar_graphs(graphs, params)
        got = evaluate_abs(tables, torch.from_numpy(x)).double().numpy()
        # A sum that cancels to 0 in exact arithmetic leaves float64 noise
        # about 1e-16 of its terms in ``want``.
        np.testing.assert_allclose(got, want, rtol=ORACLE_RTOL, atol=1e-9 * want.max(), err_msg=f"rung {k}")
        raw = compile_module._compile_prefactor(graphs)
        if coefficient_bound(tables.node_phases, tables.phase_pairs, raw) > INT32_LIMIT:
            overflowing += 1
            assert coefficient_bound(tables.node_phases, tables.phase_pairs, tables.prefactor) <= INT32_LIMIT
    assert overflowing >= 9


def test_unstripped_tables_overflow(grown2, walked_rows, monkeypatch):
    """The fault itself: with the move of factors of two turned off, the
    exact evaluation of the heavy rungs differs from their graphs' sums."""
    _, _, rungs = grown2
    monkeypatch.setattr(compile_module, "INT32_LIMIT", 1 << 4096)
    off = []
    for k, (x, want) in walked_rows.items():
        raw = compile_scalar_graphs(*rungs[k])
        got = evaluate_abs(raw, torch.from_numpy(x)).double().numpy()
        if (np.abs(got - want) > 1e-3 * want.max()).any():
            off.append(k)
    assert off == list(range(4, 13))  # the nine rungs over the int32 bound


# ----------------------------------------------------- statevector oracle
#
# The circuit with a drawn noise configuration's Pauli errors (and record
# flips) put in as gates, everything else noiseless, run on VecSim. Random
# measurement outcomes branch the state; measurements after the last gate
# are read from each branch's final state at once. Qubits live in the state
# from their first use to a measurement that a reset follows, so the
# 21-qubit circuit never holds more than 17 at a time.

_NOISE = ("DEPOLARIZE1", "DEPOLARIZE2", "X_ERROR", "Z_ERROR")


def _pauli_product(state, paulis):
    """P|state> for (pauli, axis) pairs."""
    sign = np.ones((1,) * state.ndim)
    for p, ax in paulis:
        if p in "ZY":
            shape = [1] * state.ndim
            shape[ax] = 2
            sign = sign * np.array([1.0, -1.0]).reshape(shape)
    out = state * sign
    for p, ax in paulis:
        if p in "XY":
            out = np.flip(out, axis=ax)
    return out * 1j ** sum(p == "Y" for p, _ in paulis)


def oracle_marginals(circuit, e_bits, outputs) -> np.ndarray:
    """Probability of every pattern of ``outputs`` (detector indices, then
    observables; bit j of the pattern is output j) under the error bits
    ``e_bits``, in the order the parser numbers them."""
    ins = list(circuit._stim_circ.flattened())
    last_use = {}
    for i, instr in enumerate(ins):
        for t in instr.targets_copy():
            if not t.is_measurement_record_target and not t.is_combiner:
                last_use[t.value] = i
    terminal = 1 + max(
        i for i, instr in enumerate(ins) if instr.name not in ("M", "MX", "DETECTOR", "OBSERVABLE_INCLUDE", "TICK")
    )
    axes: dict[int, int] = {}
    root = VecSim(0)
    root.state = np.ones((), dtype=complex)
    branches = [(1.0, root, [])]
    deferred: dict[int, int] = {}  # record index -> qubit read at the end
    dets, obs = [], {}
    e = iter(e_bits)

    def add(q, plus=False):
        ket = np.array([1.0, 1.0]) / np.sqrt(2) if plus else np.array([1.0, 0.0])
        axes[q] = len(axes)
        for _, s, _ in branches:
            s.state = np.multiply.outer(s.state, ket.astype(complex))

    def apply(U, *qs):
        for q in qs:
            if q not in axes:
                add(q)
        for _, s, _ in branches:
            if len(qs) == 1:
                s.apply_1q(U, axes[qs[0]])
            else:
                s.apply_2q(U, axes[qs[0]], axes[qs[1]])

    def measure(paulis, flip):
        nonlocal branches
        out = []
        for w, s, rec in branches:
            moved = _pauli_product(s.state, paulis)
            halves = ((s.state + moved) / 2, (s.state - moved) / 2)
            probs = [float(np.vdot(h, h).real) for h in halves]
            for bit in (0, 1):
                pb = probs[bit] / sum(probs)
                if pb > 1e-12:
                    t = VecSim(0)
                    t.state = halves[bit] / np.sqrt(probs[bit])
                    out.append((w * pb, t, rec + [bit ^ flip]))
        branches = out

    for i, instr in enumerate(ins):
        name, args, targets = instr.name, instr.gate_args_copy(), instr.targets_copy()
        n_rec = len(branches[0][2])
        if name in _NOISE:
            for t in targets:
                if name in ("X_ERROR", "Z_ERROR"):
                    fired = [name[0]] if next(e) else []
                else:  # Z then X bit per qubit, as core/instructions.py numbers them
                    z, x = next(e), next(e)
                    fired = [p for p, on in (("Z", z), ("X", x)) if on]
                for p in fired:
                    apply(PAULI[p], t.value)
        elif name == "TICK":
            continue
        elif name == "DETECTOR":
            dets.append([n_rec + t.value for t in targets])
        elif name == "OBSERVABLE_INCLUDE":
            obs.setdefault(int(args[0]), []).extend(n_rec + t.value for t in targets)
        elif name in ("R", "RX"):
            for t in targets:
                assert t.value not in axes
                add(t.value, plus=name == "RX")
        elif name in ("S", "S_DAG") and is_t_tag(instr.tag):
            for t in targets:
                apply(SINGLE["T" if name == "S" else "T_DAG"], t.value)
        elif name in SINGLE:
            for t in targets:
                apply(SINGLE[name], t.value)
        elif name in TWO:
            for j in range(0, len(targets), 2):
                apply(TWO[name], targets[j].value, targets[j + 1].value)
        elif name == "MPP":
            for paulis, invert in _iter_pauli_products(instr):
                flip = int(invert) ^ (next(e) if args else 0)
                for _, q in paulis:
                    if q not in axes:
                        add(q)
                measure([(p, axes[q]) for p, q in paulis], flip)
        elif name in ("M", "MX"):
            assert not args
            for t in targets:
                q, inv = t.value, int(t.is_inverted_result_target)
                if name == "MX":
                    apply(H, q)
                if i >= terminal and last_use[q] == i:
                    deferred[len(branches[0][2])] = q
                    for _, _, rec in branches:
                        rec.append(inv)
                    continue
                ax = axes.pop(q)
                measure([("Z", ax)], inv)
                for _, s, rec in branches:
                    s.state = np.ascontiguousarray(np.take(s.state, rec[-1] ^ inv, axis=ax))
                for k, v in axes.items():
                    axes[k] = v - (v > ax)
        else:
            raise ValueError(f"the oracle does not run {name}")
    assert next(e, None) is None

    recs = sorted(deferred)
    order = [axes[deferred[r]] for r in recs]
    idx = np.arange(1 << len(recs))
    sets = [dets[o] if o < len(dets) else obs[o - len(dets)] for o in outputs]
    totals = np.zeros(1 << len(outputs))
    for w, s, rec in branches:
        prob = np.abs(s.state) ** 2
        prob = prob.sum(axis=tuple(a for a in range(prob.ndim) if a not in order))
        prob = np.transpose(prob, [sorted(order).index(a) for a in order]).reshape(-1)
        pattern = np.zeros_like(idx)
        for k, members in enumerate(sets):
            bit = np.zeros_like(idx)
            for r in members:
                bit ^= rec[r]
                if r in deferred:
                    bit ^= (idx >> (len(recs) - 1 - recs.index(r))) & 1
            pattern |= bit << k
        totals += np.bincount(pattern, weights=w * prob / prob.sum(), minlength=len(totals))
    return totals


def _noise_configurations(circuit, component, count: int, seed: int = 0):
    """The first ``count`` seeded draws of the circuit's channels whose f-bits
    reach ``component``: (e, f) each, f = T e (mod 2)."""
    prepared = prepare_graph(circuit, sample_detectors=True)
    T = prepared.error_transform.astype(np.int64)
    selected = np.asarray(pipeline._get_f_indices(prepared.graph))[list(component.f_selection)]
    rng = np.random.default_rng(seed)
    found = []
    while len(found) < count:
        bits = []
        for probs in prepared.channel_probs:
            pattern = rng.choice(len(probs), p=probs / probs.sum())
            bits += [(pattern >> b) & 1 for b in range(int(np.log2(len(probs))))]
        e = np.array(bits, dtype=np.int64)
        f = (T @ e) % 2
        if f[selected].any():
            found.append((e, f[selected].astype(np.uint8)))
    return found


@pytest.fixture(scope="module")
def configurations(grown2):
    circuit, exported, _ = grown2
    return _noise_configurations(circuit, exported.program.components[0], 3)


@pytest.mark.parametrize("which", range(3))
def test_prefix_marginals_equal_statevector_oracle(which, grown2, configurations):
    circuit, exported, _ = grown2
    comp = exported.program.components[0]
    e, f = configurations[which]
    want_all = oracle_marginals(circuit, e, list(comp.output_indices))
    assert want_all.sum() == pytest.approx(1.0, abs=1e-12)
    rungs = comp.compiled_scalar_graphs
    norm = float(evaluate_abs(rungs[0], torch.from_numpy(f[None])).double()[0])
    live = [()]
    for k in range(1, len(rungs)):
        prefixes = [p + (b,) for p in live for b in (0, 1)]
        x = np.array([np.concatenate([f, p]) for p in prefixes], dtype=np.uint8)
        got = evaluate_abs(rungs[k], torch.from_numpy(x)).double().numpy() / norm
        codes = [sum(b << j for j, b in enumerate(p)) for p in prefixes]
        low = np.arange(len(want_all)) & ((1 << k) - 1)
        want = np.array([want_all[low == c].sum() for c in codes])
        np.testing.assert_allclose(got, want, rtol=ORACLE_RTOL, atol=1e-12, err_msg=f"rung {k}")
        live = [p for p, w in zip(prefixes, want) if w > 1e-12]


@pytest.mark.parametrize("checks", [1, 2])
def test_noiseless_grown_compile_equals_tsim_tpu(checks):
    text = str(cultivation_d3_grown(p=0.0, checks=checks))
    got = port_compile(text, sample_detectors=True, mode="sequential")
    want = reference_compile(text, sample_detectors=True, mode="sequential")
    assert_same_leaves(got, want)


# ------------------------------------------------ the bound, in integers


def test_squared_embeddings_are_exact():
    """``_norm_squared``'s A + B sqrt(2) is the largest |sigma_j(x)|^2."""
    rng = np.random.default_rng(3)
    w8 = np.exp(1j * np.pi / 4 * np.arange(8))
    for c in rng.integers(-(2**20), 2**20, size=(200, 4)):
        a, b = compile_module._norm_squared(c)
        want = max(abs(sum(int(c[k]) * w8[(j * k) % 8] for k in range(4))) ** 2 for j in (1, 3, 5, 7))
        assert b >= 0 and a + b * np.sqrt(2) == pytest.approx(want, rel=1e-12)


def test_committed_rung_at_the_limit_is_exactly_two_to_the_31():
    """2-check cultivation's rung 8 is bounded by exactly 2^31, in integers,
    whatever the platform's floating point; its neighbours stay under it."""
    from tsim_tpu_torch.models.exported import CULTIVATION_PROGRAM
    from tsim_tpu_torch.program_io import load_npz

    rungs = load_npz(CULTIVATION_PROGRAM).program.components[0].compiled_scalar_graphs
    bounds = [coefficient_bound(r.node_phases, r.phase_pairs, r.prefactor) for r in rungs]
    assert bounds[8] == INT32_LIMIT
    assert all(b < INT32_LIMIT for k, b in enumerate(bounds) if k != 8)


@pytest.mark.parametrize("i", range(4))
def test_a_sum_at_the_limit_keeps_its_magnitude(i):
    """The one value over int32 that a bound of 2^31 admits, 2^31 w^i, is
    held as -2^31 w^i: the exact evaluation's magnitude is unchanged."""
    from tsim_tpu_torch.core.exact_scalar import ExactScalarArray, exact_magnitude

    coeffs = torch.zeros((4, 1, 2), dtype=torch.int32)
    coeffs[i, 0] = torch.tensor([(1 << 31) - 1, 1], dtype=torch.int32)  # a bound of 2^31
    total = ExactScalarArray(coeffs=coeffs, power=torch.zeros((1, 2), dtype=torch.int32)).sum()
    assert int(total.coeffs[i, 0]) < 0  # wrapped
    true = torch.zeros((4, 1), dtype=torch.int32)
    true[i] = 1 << 30  # 2^31 w^i as 2^30 w^i * 2^1
    assert torch.equal(exact_magnitude(total.coeffs, total.power),
                       exact_magnitude(true, torch.ones(1, dtype=torch.int32)))
