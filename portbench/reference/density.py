"""The exact joint distribution of a noisy circuit's detectors and
observables, by a density-matrix simulation in plain PyTorch on the CPU.

The state is a stack of density matrices, one a *label*: the values of the
output bits (detectors, then observables) that the measurements so far have
decided. A measurement splits every matrix into its two projections and
adds the one of outcome 1 to the label with that measurement's output bits
flipped, so the stack holds the joint distribution of every output together
with the quantum state, and nothing is sampled. Pauli channels act on the
matrices exactly. A qubit that is measured and then reset, or never touched
again, is traced out as it is measured, and a reset brings it back, so the
matrices stay no larger than the live qubits need.

``rounding`` is applied to the stack after every instruction: the identity
for the reference (complex128), a round trip through a narrower float type
for the control of the check that decides ``correct``.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from .stim_text import (
    MEASUREMENTS, ONE_QUBIT_GATES, ONE_QUBIT_NOISE, RESETS, TWO_QUBIT_GATES, TWO_QUBIT_NOISE,
    Layout, Op, layout, parse,
)

_R = 1 / math.sqrt(2)
_W = complex(math.cos(math.pi / 4), math.sin(math.pi / 4))
PAULI = {
    "I": [[1, 0], [0, 1]],
    "X": [[0, 1], [1, 0]],
    "Y": [[0, -1j], [1j, 0]],
    "Z": [[1, 0], [0, -1]],
}
GATES = {
    **PAULI,
    "H": [[_R, _R], [_R, -_R]],
    "S": [[1, 0], [0, 1j]],
    "S_DAG": [[1, 0], [0, -1j]],
    "T": [[1, 0], [0, _W]],
    "T_DAG": [[1, 0], [0, _W.conjugate()]],
    "SQRT_X": [[(1 + 1j) / 2, (1 - 1j) / 2], [(1 - 1j) / 2, (1 + 1j) / 2]],
    "SQRT_X_DAG": [[(1 - 1j) / 2, (1 + 1j) / 2], [(1 + 1j) / 2, (1 - 1j) / 2]],
    "SQRT_Y": [[(1 + 1j) / 2, -(1 + 1j) / 2], [(1 + 1j) / 2, (1 + 1j) / 2]],
    "SQRT_Y_DAG": [[(1 - 1j) / 2, (1 - 1j) / 2], [-(1 - 1j) / 2, (1 - 1j) / 2]],
}


def bf16_rounding(x: torch.Tensor) -> torch.Tensor:
    """Round a complex128 stack's real and imaginary parts to bfloat16."""
    parts = torch.view_as_real(x.contiguous())
    return torch.view_as_complex(parts.to(torch.bfloat16).to(torch.float64).contiguous())


class _Stack:
    """The labelled density matrices: ``rho`` is (L, D, D) complex, D = 2^k
    for the ``live`` qubits (the first is the most significant index bit),
    L = 2^len(``bits``), label bit i being output ``bits[i]``."""

    def __init__(self, rounding):
        self.rho = torch.ones((1, 1, 1), dtype=torch.complex128)
        self.live: list[int] = []
        self.bits: list[int] = []
        self.round = rounding
        self._mats: dict[str, torch.Tensor] = {}

    def mat(self, name: str) -> torch.Tensor:
        if name not in self._mats:
            self._mats[name] = torch.tensor(GATES[name], dtype=torch.complex128)
        return self._mats[name]

    # --- shapes -----------------------------------------------------------
    def _split(self, q: int) -> tuple[int, int, int]:
        a = self.live.index(q)
        k = len(self.live)
        return self.rho.shape[0], 2 ** a, 2 ** (k - a - 1)

    def left(self, m: torch.Tensor, q: int, rho=None) -> torch.Tensor:
        rho = self.rho if rho is None else rho
        L, A, B = self._split(q)
        D = rho.shape[-1]
        x = rho.reshape(L, A, 2, B, D)
        return torch.einsum("ij,lajbc->laibc", m, x).reshape(L, D, D)

    def right(self, m: torch.Tensor, q: int, rho=None) -> torch.Tensor:
        rho = self.rho if rho is None else rho
        L, A, B = self._split(q)
        D = rho.shape[-1]
        x = rho.reshape(L, D, A, 2, B)
        return torch.einsum("lcajb,jk->lcakb", x, m).reshape(L, D, D)

    def bit_of(self, q: int) -> torch.Tensor:
        """(D,) 0/1 value of qubit ``q`` in each basis index."""
        k, a = len(self.live), self.live.index(q)
        idx = torch.arange(2 ** k)
        return (idx >> (k - 1 - a)) & 1

    # --- qubits -----------------------------------------------------------
    def add(self, q: int, basis: str) -> None:
        """Append ``q`` in |0> (basis "Z") or |+> (basis "X")."""
        one = torch.tensor([[1, 0], [0, 0]] if basis == "Z" else [[0.5, 0.5], [0.5, 0.5]],
                           dtype=torch.complex128)
        L, D = self.rho.shape[0], self.rho.shape[-1]
        self.rho = torch.einsum("lij,ab->liajb", self.rho, one).reshape(L, 2 * D, 2 * D)
        self.live.append(q)

    def ensure(self, qubits) -> None:
        for q in qubits:
            if q not in self.live:
                self.add(q, "Z")

    def blocks(self, q: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The (L, D/2, D/2) diagonal blocks of ``q`` = 0 and ``q`` = 1."""
        L, A, B = self._split(q)
        x = self.rho.reshape(L, A, 2, B, A, 2, B)
        half = A * B
        return x[:, :, 0, :, :, 0, :].reshape(L, half, half), x[:, :, 1, :, :, 1, :].reshape(L, half, half)

    def drop(self, q: int) -> None:
        """Trace ``q`` out."""
        b0, b1 = self.blocks(q)
        self.rho = b0 + b1
        self.live.remove(q)

    def twirled(self, qubits) -> torch.Tensor:
        """Tr_qubits(rho) (x) I on those qubits: the sum of P rho P over all
        Pauli strings P on ``qubits``, over 2^len(qubits)."""
        out = self.rho
        for q in qubits:
            L, A, B = self._split(q)
            D = out.shape[-1]
            x = out.reshape(L, A, 2, B, A, 2, B)
            tr = x[:, :, 0, :, :, 0, :] + x[:, :, 1, :, :, 1, :]
            eye = torch.eye(2, dtype=out.dtype)
            out = torch.einsum("lacbd,ij->laicbjd", tr, eye).reshape(L, D, D)
        return out

    # --- labels -----------------------------------------------------------
    def label_mask(self, outputs: list[int]) -> int:
        """The label bits of ``outputs``, each new output given a bit."""
        mask = 0
        for o in outputs:
            if o not in self.bits:
                self.bits.append(o)
            mask |= 1 << self.bits.index(o)
        return mask

    def record(self, zero: torch.Tensor, one: torch.Tensor, flip: float, outputs: list[int]) -> torch.Tensor:
        """The stack after a measurement whose outcomes' states are ``zero``
        and ``one``, its record flipped with probability ``flip``."""
        if not outputs:
            return zero + one
        if flip:
            zero, one = (1 - flip) * zero + flip * one, (1 - flip) * one + flip * zero
        mask = self.label_mask(outputs)
        labels = 2 ** len(self.bits)
        if zero.shape[0] != labels:
            pad = torch.zeros((labels - zero.shape[0], *zero.shape[1:]), dtype=zero.dtype)
            zero, one = torch.cat([zero, pad]), torch.cat([one, pad])
        index = torch.arange(labels) ^ mask
        return zero + one[index]


def _touches(op: Op) -> list[int]:
    if op.name == "MPP":
        return [q for prod in op.products for q, _ in prod]
    return op.qubits


def _discard_after_measuring(ops: list[Op]) -> list[set[int]]:
    """For each instruction, the qubits it measures (Z or X basis) whose
    next use is a reset, or that are never used again."""
    out: list[set[int]] = [set() for _ in ops]
    seen_reset_or_end: dict[int, bool] = {}
    for i in range(len(ops) - 1, -1, -1):
        op = ops[i]
        if op.name in MEASUREMENTS:
            out[i] = {q for q in op.qubits if seen_reset_or_end.get(q, True)}
        for q in _touches(op):
            seen_reset_or_end[q] = op.name in RESETS
    return out


def output_distribution(text: str, *,
                        rounding: Callable[[torch.Tensor], torch.Tensor] | None = None) -> tuple[np.ndarray, Layout]:
    """(q, layout): q[c] is the probability that the outputs read ``c``, bit
    i of ``c`` being output i (detectors first, then observables), a float64
    array of 2^num_outputs entries."""
    ops = parse(text)
    lay = layout(ops)
    discard = _discard_after_measuring(ops)
    st = _Stack(rounding or (lambda x: x))
    measured = 0
    for i, op in enumerate(ops):
        name = op.name
        if name in ("DETECTOR", "OBSERVABLE_INCLUDE"):
            continue
        if name in ONE_QUBIT_GATES:
            st.ensure(op.qubits)
            u = st.mat(name)
            ud = u.conj().T
            for q in op.qubits:
                st.rho = st.right(ud, q, st.left(u, q))
        elif name in TWO_QUBIT_GATES:
            st.ensure(op.qubits)
            for a, b in zip(op.qubits[::2], op.qubits[1::2]):
                ba, bb = st.bit_of(a), st.bit_of(b)
                if name == "CZ":
                    s = (1 - 2 * (ba & bb)).to(torch.complex128)
                    st.rho = st.rho * (s[:, None] * s[None, :])
                else:
                    k = len(st.live)
                    sa, sb = 1 << (k - 1 - st.live.index(a)), 1 << (k - 1 - st.live.index(b))
                    idx = torch.arange(2 ** k)
                    if name == "SWAP":
                        perm = torch.where(ba != bb, idx ^ (sa | sb), idx)
                    else:  # CX, CNOT: a controls b
                        perm = torch.where(ba == 1, idx ^ sb, idx)
                    st.rho = st.rho[:, perm][:, :, perm]
        elif name in RESETS:
            for q in op.qubits:
                if q in st.live:
                    st.drop(q)
                st.add(q, RESETS[name])
        elif name in ONE_QUBIT_NOISE:
            st.ensure(op.qubits)
            for q in op.qubits:
                if name == "DEPOLARIZE1":
                    p = op.args[0]
                    st.rho = (1 - 4 * p / 3) * st.rho + (2 * p / 3) * st.twirled([q])
                else:
                    probs = dict(zip("XYZ", op.args)) if name == "PAULI_CHANNEL_1" else {name[0]: op.args[0]}
                    acc = (1 - sum(probs.values())) * st.rho
                    for letter, p in probs.items():
                        if p:
                            m = st.mat(letter)
                            acc = acc + p * st.right(m, q, st.left(m, q))
                    st.rho = acc
        elif name in TWO_QUBIT_NOISE:
            st.ensure(op.qubits)
            p = op.args[0]
            for a, b in zip(op.qubits[::2], op.qubits[1::2]):
                st.rho = (1 - 16 * p / 15) * st.rho + (4 * p / 15) * st.twirled([a, b])
        elif name in MEASUREMENTS:
            st.ensure(op.qubits)
            flip = op.args[0] if op.args else 0.0
            h = st.mat("H")
            for q in op.qubits:
                if MEASUREMENTS[name] == "X":
                    st.rho = st.right(h, q, st.left(h, q))
                outputs = lay.outputs_of_measurement[measured]
                measured += 1
                if q in discard[i]:
                    b0, b1 = st.blocks(q)
                    st.live.remove(q)
                    st.rho = st.record(b0, b1, flip, outputs)
                else:
                    bit = st.bit_of(q)
                    keep0 = ((1 - bit)[:, None] * (1 - bit)[None, :]).to(torch.complex128)
                    keep1 = (bit[:, None] * bit[None, :]).to(torch.complex128)
                    st.rho = st.record(st.rho * keep0, st.rho * keep1, flip, outputs)
                    if MEASUREMENTS[name] == "X":
                        st.rho = st.right(h, q, st.left(h, q))
                st.rho = st.round(st.rho)
        elif name == "MPP":
            flip = op.args[0] if op.args else 0.0
            for prod in op.products:
                st.ensure([q for q, _ in prod])
                left, right = st.rho, st.rho
                for q, letter in prod:
                    left = st.left(st.mat(letter), q, left)
                    right = st.right(st.mat(letter), q, right)
                both = right
                for q, letter in prod:
                    both = st.left(st.mat(letter), q, both)
                plus = (st.rho + left + right + both) / 4
                minus = (st.rho - left - right + both) / 4
                outputs = lay.outputs_of_measurement[measured]
                measured += 1
                st.rho = st.round(st.record(plus, minus, flip, outputs))
        else:
            raise ValueError(f"instruction {name} is not simulated")
        st.rho = st.round(st.rho)
    probs = torch.diagonal(st.rho, dim1=1, dim2=2).real.sum(-1).numpy()
    codes = np.zeros(len(probs), dtype=np.int64)
    for i, o in enumerate(st.bits):
        codes |= ((np.arange(len(probs)) >> i) & 1) << o
    q = np.zeros(1 << lay.num_outputs, dtype=np.float64)
    np.add.at(q, codes, probs)
    return q, lay
