"""Stabilizer tableau simulator (Aaronson-Gottesman CHP style).

In-house replacement for the Stim tableau engine the reference leans on for
noiseless reference samples and m2d conversion (reference ``SURVEY.md``
section 2.1 row 1). Every named Clifford gate is decomposed at import time
into a word over the canonical primitives {H, S, CX} by BFS over the gate
unitaries (up to global phase), so the gate set exactly matches the rest of
the framework with no hand-written sign rules.
"""

from __future__ import annotations

import numpy as np

from ..external.vec_sim.vec_sim import PAULI, SINGLE, TWO

_P_OF_BITS = {(0, 0): "I", (1, 0): "X", (0, 1): "Z", (1, 1): "Y"}
_BITS_OF_P = {v: k for k, v in _P_OF_BITS.items()}


# ---------------------------------------------------------------------------
# Frame-action tables (sign-free) for the frame sampler.
# ---------------------------------------------------------------------------

def _identify_pauli(M: np.ndarray, nq: int):
    import itertools

    for names in itertools.product("IXYZ", repeat=nq):
        P = np.array([[1.0 + 0j]])
        for nm in names:
            P = np.kron(P, np.eye(2) if nm == "I" else PAULI[nm])
        for sign in (1, -1):
            if np.allclose(M, sign * P, atol=1e-9):
                return sign, names
    raise ValueError("not a signed Pauli product")


def _action_1q(U):
    return {
        nm: _identify_pauli(U @ PAULI[nm] @ U.conj().T, 1) for nm in ("X", "Z")
    }


def _action_2q(U):
    out = {}
    for inp in (("X", "I"), ("Z", "I"), ("I", "X"), ("I", "Z")):
        P = np.kron(
            np.eye(2) if inp[0] == "I" else PAULI[inp[0]],
            np.eye(2) if inp[1] == "I" else PAULI[inp[1]],
        )
        out[inp] = _identify_pauli(U @ P @ U.conj().T, 2)
    return out


ACTIONS_1Q = {
    name: {k: (s, p[0]) for k, (s, p) in _action_1q(U).items()}
    for name, U in SINGLE.items()
    if name not in ("I", "T", "T_DAG")
}
ACTIONS_2Q = {name: _action_2q(U) for name, U in TWO.items()}


# ---------------------------------------------------------------------------
# Gate words over {H, S, CX} found by BFS (up to global phase).
# ---------------------------------------------------------------------------

def _canon(U: np.ndarray) -> bytes:
    flat = U.ravel()
    idx = int(np.argmax(np.abs(flat) > 1e-8))
    U = U / (flat[idx] / abs(flat[idx]))
    # +0.0 normalizes negative zeros so byte keys are stable.
    return (np.round(U, 6) + (0.0 + 0.0j)).tobytes()


def _bfs_words(targets: dict[str, np.ndarray], gens: dict, dim: int):
    from collections import deque

    want: dict[bytes, list[str]] = {}
    for name, U in targets.items():
        want.setdefault(_canon(U), []).append(name)
    words: dict[str, list] = {}
    start = np.eye(dim, dtype=complex)
    seen = {_canon(start)}
    queue = deque([(start, [])])
    while queue and len(words) < len(targets):
        U, word = queue.popleft()
        key = _canon(U)
        for nm in want.get(key, ()):
            if nm not in words:
                words[nm] = word
        if len(word) >= 9:
            continue
        for gname, G in gens.items():
            V = G @ U
            k = _canon(V)
            if k not in seen:
                seen.add(k)
                queue.append((V, word + [gname]))
    missing = set(targets) - set(words)
    if missing:
        raise RuntimeError(f"BFS failed to decompose: {missing}")
    return words


_H1 = SINGLE["H"]
_S1 = SINGLE["S"]
_GENS_1Q = {"H:0": _H1, "S:0": _S1}
_WORDS_1Q = _bfs_words(
    {n: U for n, U in SINGLE.items() if n not in ("I", "T", "T_DAG")}, _GENS_1Q, 2
)

_I2 = np.eye(2)
_GENS_2Q = {
    "H:0": np.kron(_H1, _I2),
    "H:1": np.kron(_I2, _H1),
    "S:0": np.kron(_S1, _I2),
    "S:1": np.kron(_I2, _S1),
    "CX:0,1": TWO["CX"],
    "CX:1,0": np.array(
        [[1, 0, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0], [0, 1, 0, 0]], dtype=complex
    ),
}
_WORDS_2Q = _bfs_words(dict(TWO), _GENS_2Q, 4)


class TableauSimulator:
    """CHP tableau: rows 0..n-1 destabilizers, rows n..2n-1 stabilizers."""

    def __init__(self, num_qubits: int, rng: np.random.Generator | None = None):
        n = self.n = num_qubits
        self.x = np.zeros((2 * n, n), dtype=np.uint8)
        self.z = np.zeros((2 * n, n), dtype=np.uint8)
        self.r = np.zeros(2 * n, dtype=np.uint8)
        for i in range(n):
            self.x[i, i] = 1
            self.z[n + i, i] = 1
        self.rng = rng if rng is not None else np.random.default_rng()

    # --------------------------------------------------------- primitives
    def _h(self, q: int) -> None:
        self.r ^= self.x[:, q] & self.z[:, q]
        self.x[:, q], self.z[:, q] = self.z[:, q].copy(), self.x[:, q].copy()

    def _s(self, q: int) -> None:
        self.r ^= self.x[:, q] & self.z[:, q]
        self.z[:, q] ^= self.x[:, q]

    def _cx(self, c: int, t: int) -> None:
        self.r ^= self.x[:, c] & self.z[:, t] & (self.x[:, t] ^ self.z[:, c] ^ 1)
        self.x[:, t] ^= self.x[:, c]
        self.z[:, c] ^= self.z[:, t]

    def apply_gate(self, name: str, qubits: list[int]) -> None:
        name = name.upper()
        if name == "I":
            return
        if len(qubits) == 1:
            word = _WORDS_1Q.get(name)
            if word is None:
                raise ValueError(f"Unknown Clifford gate: {name}")
            (q,) = qubits
            for step in word:
                g, _ = step.split(":")
                if g == "H":
                    self._h(q)
                else:
                    self._s(q)
            return
        word = _WORDS_2Q.get(name)
        if word is None:
            raise ValueError(f"Unknown Clifford gate: {name}")
        q0, q1 = qubits
        qm = {0: q0, 1: q1}
        for step in word:
            g, pos = step.split(":")
            if g == "H":
                self._h(qm[int(pos)])
            elif g == "S":
                self._s(qm[int(pos)])
            else:
                a, b = pos.split(",")
                self._cx(qm[int(a)], qm[int(b)])

    # ------------------------------------------------------- measurement
    def measure(self, q: int, forced: int | None = None) -> tuple[int, bool]:
        n = self.n
        anti = np.flatnonzero(self.x[n:, q])
        if anti.size:
            p = int(anti[0]) + n
            outcome = int(self.rng.integers(0, 2)) if forced is None else int(forced)
            for i in np.flatnonzero(self.x[:, q]):
                if i != p:
                    self._rowsum(int(i), p)
            self.x[p - n] = self.x[p]
            self.z[p - n] = self.z[p]
            self.r[p - n] = self.r[p]
            self.x[p] = 0
            self.z[p] = 0
            self.z[p, q] = 1
            self.r[p] = outcome
            return outcome, False
        sx = np.zeros(n, dtype=np.uint8)
        sz = np.zeros(n, dtype=np.uint8)
        sr = 0
        sg = 0
        for i in np.flatnonzero(self.x[:n, q]):
            sx, sz, sr, sg = _mul_rows(
                sx, sz, sr, sg, self.x[n + i], self.z[n + i], int(self.r[n + i])
            )
        assert sg % 2 == 0, "deterministic measurement with imaginary phase"
        return int((sr + (sg % 4) // 2) % 2), True

    def _rowsum(self, h: int, i: int) -> None:
        sx, sz, sr, sg = _mul_rows(
            self.x[h], self.z[h], int(self.r[h]), 0, self.x[i], self.z[i], int(self.r[i])
        )
        # Phases of destabilizer rows (h < n) are irrelevant; only stabilizer
        # rows must multiply to a real sign.
        if h >= self.n:
            assert sg % 2 == 0, "rowsum produced imaginary phase"
        self.x[h] = sx
        self.z[h] = sz
        self.r[h] = (sr + (sg % 4) // 2) % 2

    def reset(self, q: int) -> None:
        out, _ = self.measure(q)
        if out:
            self.apply_gate("X", [q])

    def measure_pauli_product(
        self, paulis: list[tuple[str, int]], forced: int | None = None
    ) -> tuple[int, bool]:
        pre = []
        for p, q in paulis:
            if p == "X":
                pre.append(("H", q))
            elif p == "Y":
                pre.append(("H_YZ", q))
        for g, q in pre:
            self.apply_gate(g, [q])
        qubits = [q for _, q in paulis]
        last = qubits[-1]
        for q in qubits[:-1]:
            self.apply_gate("CX", [q, last])
        out, det = self.measure(last, forced=forced)
        for q in reversed(qubits[:-1]):
            self.apply_gate("CX", [q, last])
        for g, q in reversed(pre):
            self.apply_gate(g, [q])
        return out, det


def _mul_rows(x1, z1, r1: int, g1: int, x2, z2, r2: int):
    """Multiply Pauli rows in the standard CHP convention.

    Rows represent (-1)^r * prod_q P_q with P given by (x, z) bits and
    Y = i X Z. Returns (x, z, r, g) where g accumulates the power of i
    (must end even; r absorbs g // 2 at the caller).
    """
    # Aaronson-Gottesman g-function per qubit.
    x1i = x1.astype(np.int8)
    z1i = z1.astype(np.int8)
    x2i = x2.astype(np.int8)
    z2i = z2.astype(np.int8)
    g = np.zeros_like(x1i)
    m11 = (x1i == 1) & (z1i == 1)
    m10 = (x1i == 1) & (z1i == 0)
    m01 = (x1i == 0) & (z1i == 1)
    g[m11] = (z2i - x2i)[m11]
    g[m10] = (z2i * (2 * x2i - 1))[m10]
    g[m01] = (x2i * (1 - 2 * z2i))[m01]
    total_g = (g1 + int(g.sum())) % 4
    nx = (x1 ^ x2).astype(np.uint8)
    nz = (z1 ^ z2).astype(np.uint8)
    nr = (r1 + r2) % 2
    return nx, nz, nr, total_g
