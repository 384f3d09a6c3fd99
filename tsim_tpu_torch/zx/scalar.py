"""Symbolic scalar for parametric ZX diagrams.

A diagram's global scalar is a product of closed-form factors and five
*symbolic term families* whose values depend on boolean parameters (error
bits ``e``/``f``, measurement bits ``m``). This mirrors the scalar model of
the reference's parametric ZX engine (see reference ``tsim/compile/compile.py``
term extraction and ``tsim/core/graph.py:462-502`` for which fields exist):

    value = sqrt(2)^power2
          * exp(i*pi*phase)
          * (a + b*w + c*w^2 + d*w^3)            [exact dyadic, w = e^{i pi/4}]
          * approx_floatfactor                    [complex, non-dyadic escape]
          * (-1)^(xor of phasevars_pi)
          * prod_j prod_t exp(i*j*pi/2 * parity(P_t))   [phasevars_halfpi]
          * prod_t (-1)^(psi_t * phi_t)                 [phasevars_pi_pair]
          * prod_t (1 + exp(i*(alpha_t + pi*parity(P_t))))  [phasenodes]
          * prod_t (1 + e^{i a_t} + e^{i b_t} - e^{i(a_t+b_t)})  [phasepairs]

Parities are XORs of boolean variables. In ``phasevars_pi_pair`` sets, the
sentinel string ``"1"`` denotes the constant 1 (so ``{"1", "f0"}`` means
``1 XOR f0``).
"""

from __future__ import annotations

import cmath
import math
from dataclasses import dataclass, field
from fractions import Fraction
from typing import Iterable, Mapping

_W = cmath.exp(1j * math.pi / 4)

Frac = Fraction


def _frac(x) -> Fraction:
    if isinstance(x, Fraction):
        return x
    return Fraction(x)


@dataclass
class ExactDyadic:
    """Element a + b*w + c*i + d*w^3 of Z[w], w = e^{i pi/4} (w^3 = -conj(w))."""

    a: int = 1
    b: int = 0
    c: int = 0
    d: int = 0

    def copy(self) -> "ExactDyadic":
        return ExactDyadic(self.a, self.b, self.c, self.d)

    def __mul__(self, o: "ExactDyadic") -> "ExactDyadic":
        # w^4 = -1: (a1 + b1 w + c1 w^2 + d1 w^3)(a2 + ...) reduced mod w^4+1
        a1, b1, c1, d1 = self.a, self.b, self.c, self.d
        a2, b2, c2, d2 = o.a, o.b, o.c, o.d
        return ExactDyadic(
            a1 * a2 - b1 * d2 - c1 * c2 - d1 * b2,
            a1 * b2 + b1 * a2 - c1 * d2 - d1 * c2,
            a1 * c2 + b1 * b2 + c1 * a2 - d1 * d2,
            a1 * d2 + b1 * c2 + c1 * b2 + d1 * a2,
        )

    def is_zero(self) -> bool:
        return self.a == 0 and self.b == 0 and self.c == 0 and self.d == 0

    def to_complex(self) -> complex:
        return self.a + self.b * _W + self.c * 1j + self.d * _W * 1j

    def mul_omega_pow(self, k: int) -> "ExactDyadic":
        """Multiply by w^k in-place-free."""
        k %= 8
        out = self.copy()
        for _ in range(k):
            out = ExactDyadic(-out.d, out.a, out.b, out.c)
        return out


def omega_pow_dyadic(k: int) -> ExactDyadic:
    return ExactDyadic(1, 0, 0, 0).mul_omega_pow(k)


@dataclass
class PhasePair:
    """Term (1 + e^{i a} + e^{i b} - e^{i (a+b)}) with parametric a, b.

    ``alpha``/``beta`` are the constant parts in eighth-turns (units of pi/4),
    each augmented by pi * parity(paramsA/B).
    """

    alpha: int
    beta: int
    paramsA: frozenset
    paramsB: frozenset

    def conjugate(self) -> "PhasePair":
        return PhasePair((-self.alpha) % 8, (-self.beta) % 8, self.paramsA, self.paramsB)


def _xor_set(a: frozenset, b: Iterable) -> frozenset:
    return frozenset(a ^ frozenset(b))


def _parity(vals: Mapping[str, int], varset: Iterable[str]) -> int:
    p = 0
    for v in varset:
        if v == "1":
            p ^= 1
        else:
            p ^= int(vals.get(v, 0)) & 1
    return p


@dataclass
class Scalar:
    """Symbolic global scalar of a parametric ZX diagram."""

    power2: int = 0  # multiplies by sqrt(2)^power2
    phase: Fraction = field(default_factory=lambda: Fraction(0))  # e^{i pi phase}
    floatfactor: ExactDyadic = field(default_factory=ExactDyadic)
    approximate_floatfactor: complex = 1.0
    is_zero: bool = False
    phasevars_pi: frozenset = frozenset()  # (-1)^(xor of vars)
    # {1: [varset, ...], 3: [varset, ...]}
    phasevars_halfpi: dict = field(default_factory=dict)
    phasevars_pi_pair: list = field(default_factory=list)  # [(psiset, phiset), ...]
    phasenodes: list = field(default_factory=list)  # [Fraction, ...]
    phasenodevars: list = field(default_factory=list)  # [frozenset, ...]
    phasepairs: list = field(default_factory=list)  # [PhasePair, ...]

    # ---------------------------------------------------------------- mutators
    def add_power(self, p: int) -> None:
        self.power2 += p

    def add_phase(self, alpha) -> None:
        self.phase = (self.phase + _frac(alpha)) % 2

    def mul_dyadic(self, d: ExactDyadic) -> None:
        self.floatfactor = self.floatfactor * d
        if self.floatfactor.is_zero():
            self.set_zero()

    def mul_float(self, z: complex) -> None:
        self.approximate_floatfactor *= z
        if abs(self.approximate_floatfactor) < 1e-300:
            self.set_zero()

    def set_zero(self) -> None:
        self.is_zero = True

    def add_pi_var(self, params: Iterable[str]) -> None:
        """Multiply by (-1)^(xor of params). Constants fold into phase.

        Stored as a degenerate pi-pair ``(params, {"1"})`` rather than in
        ``phasevars_pi`` because the compiled ``PiProducts`` family supports
        constant sides while bare ``phasevars_pi`` is rejected at compile time
        (mirrors reference ``compile/compile.py:357-361``).
        """
        params = frozenset(params)
        if "1" in params:
            self.add_phase(1)
            params -= {"1"}
        if params:
            self.phasevars_pi_pair.append((params, frozenset({"1"})))

    def add_halfpi(self, j: int, params: Iterable[str]) -> None:
        """Multiply by e^{i j pi/2 * parity(params)}, j in {1, 2, 3}."""
        params = frozenset(p for p in params if p != "1")
        j %= 4
        if j == 0 or not params:
            return
        if j == 2:
            # e^{i pi parity} = (-1)^parity
            self.add_pi_var(params)
            return
        self.phasevars_halfpi.setdefault(j, []).append(params)

    def add_pi_pair(self, psi: Iterable[str], phi: Iterable[str]) -> None:
        """Multiply by (-1)^(psi_parity * phi_parity); '1' = constant one."""
        psi = frozenset(psi)
        phi = frozenset(phi)
        # Degenerate cases: one side constant.
        if not psi or not phi:
            return  # parity is 0 -> factor 1
        if psi == frozenset({"1"}):
            self.add_pi_var(phi)
            return
        if phi == frozenset({"1"}):
            self.add_pi_var(psi)
            return
        self.phasevars_pi_pair.append((psi, phi))

    def add_node(self, phase, params: Iterable[str] = ()) -> None:
        """Multiply by (1 + e^{i pi (phase + parity(params))})."""
        phase = _frac(phase) % 2
        params = frozenset(params)
        if "1" in params:
            phase = (phase + 1) % 2
            params -= {"1"}
        if not params:
            if phase == 1:
                self.set_zero()
                return
            # exact closed form when dyadic (denominator 1, 2 or 4)
            if phase.denominator in (1, 2, 4):
                self.mul_dyadic(_one_plus_omega(int(phase * 4) % 8))
            else:
                self.mul_float(1 + cmath.exp(1j * math.pi * float(phase)))
            return
        if phase.denominator == 1:
            # Projector node 1 + (-1)^(phase + parity): idempotent up to a
            # factor 2 — a duplicate collapses ((1 +/- (-1)^s)^2 =
            # 2 (1 +/- (-1)^s)), and the opposite-phase node on the same
            # parity annihilates ((1+(-1)^s)(1-(-1)^s) = 0). The doubled
            # cultivation diagrams hit both constantly (34% of compiled
            # node terms were exact duplicate pairs before this).
            for ph2, vs2 in zip(self.phasenodes, self.phasenodevars):
                if vs2 != params or _frac(ph2).denominator != 1:
                    continue
                if (ph2 - phase) % 2 == 0:
                    self.add_power(2)
                    return
                self.set_zero()
                return
        self.phasenodes.append(phase)
        self.phasenodevars.append(params)

    def add_phase_pair(self, alpha8: int, beta8: int, pa: Iterable[str], pb: Iterable[str]) -> None:
        pa = frozenset(p for p in pa if p != "1")
        pb = frozenset(p for p in pb if p != "1")
        self.phasepairs.append(PhasePair(alpha8 % 8, beta8 % 8, pa, pb))

    # ---------------------------------------------------------------- algebra
    def copy(self) -> "Scalar":
        s = Scalar(
            power2=self.power2,
            phase=self.phase,
            floatfactor=self.floatfactor.copy(),
            approximate_floatfactor=self.approximate_floatfactor,
            is_zero=self.is_zero,
            phasevars_pi=self.phasevars_pi,
            phasevars_halfpi={j: list(v) for j, v in self.phasevars_halfpi.items()},
            phasevars_pi_pair=list(self.phasevars_pi_pair),
            phasenodes=list(self.phasenodes),
            phasenodevars=list(self.phasenodevars),
            phasepairs=list(self.phasepairs),
        )
        return s

    def mul(self, other: "Scalar") -> None:
        """Multiply ``other`` into ``self`` (for diagram composition)."""
        self.power2 += other.power2
        self.add_phase(other.phase)
        self.mul_dyadic(other.floatfactor)
        self.approximate_floatfactor *= other.approximate_floatfactor
        self.is_zero = self.is_zero or other.is_zero
        self.phasevars_pi = self.phasevars_pi ^ other.phasevars_pi
        for j, lst in other.phasevars_halfpi.items():
            self.phasevars_halfpi.setdefault(j, []).extend(lst)
        self.phasevars_pi_pair.extend(other.phasevars_pi_pair)
        # Route nodes through add_node so projector dedup/annihilation
        # applies across the product too. Snapshot first: add_node appends
        # to self's lists, which alias other's when self.mul(self).
        for ph, vs in list(zip(other.phasenodes, other.phasenodevars)):
            self.add_node(ph, vs)
        self.phasepairs.extend(other.phasepairs)

    def conjugate(self) -> "Scalar":
        s = self.copy()
        s.phase = (-self.phase) % 2
        f = self.floatfactor
        # conj(a + b w + c i + d w^3): w -> w^{-1} = -w^3, i -> -i, w^3 -> -w
        s.floatfactor = ExactDyadic(f.a, -f.d, -f.c, -f.b)
        s.approximate_floatfactor = self.approximate_floatfactor.conjugate() if isinstance(
            self.approximate_floatfactor, complex
        ) else self.approximate_floatfactor
        s.phasevars_halfpi = {}
        for j, lst in self.phasevars_halfpi.items():
            s.phasevars_halfpi.setdefault(4 - j, []).extend(lst)
        s.phasenodes = [(-p) % 2 for p in self.phasenodes]
        s.phasenodevars = list(self.phasenodevars)
        s.phasepairs = [pp.conjugate() for pp in self.phasepairs]
        return s

    # -------------------------------------------------------------- evaluation
    def variables(self) -> set:
        out = set(self.phasevars_pi)
        for lst in self.phasevars_halfpi.values():
            for vs in lst:
                out |= set(vs)
        for psi, phi in self.phasevars_pi_pair:
            out |= set(psi) | set(phi)
        for vs in self.phasenodevars:
            out |= set(vs)
        for pp in self.phasepairs:
            out |= set(pp.paramsA) | set(pp.paramsB)
        out.discard("1")
        return out

    def evaluate(self, vals: Mapping[str, int] | None = None) -> complex:
        """Numerically evaluate the scalar at a boolean assignment."""
        if self.is_zero:
            return 0.0
        vals = vals or {}
        z = (2 ** (self.power2 / 2.0)) * cmath.exp(1j * math.pi * float(self.phase))
        z *= self.floatfactor.to_complex()
        z *= self.approximate_floatfactor
        if _parity(vals, self.phasevars_pi):
            z = -z
        for j, lst in self.phasevars_halfpi.items():
            for vs in lst:
                if _parity(vals, vs):
                    z *= cmath.exp(1j * j * math.pi / 2)
        for psi, phi in self.phasevars_pi_pair:
            if _parity(vals, psi) and _parity(vals, phi):
                z = -z
        for ph, vs in zip(self.phasenodes, self.phasenodevars):
            a = math.pi * (float(ph) + _parity(vals, vs))
            z *= 1 + cmath.exp(1j * a)
        for pp in self.phasepairs:
            a = math.pi / 4 * pp.alpha + math.pi * _parity(vals, pp.paramsA)
            b = math.pi / 4 * pp.beta + math.pi * _parity(vals, pp.paramsB)
            z *= 1 + cmath.exp(1j * a) + cmath.exp(1j * b) - cmath.exp(1j * (a + b))
        return z

    def evaluate_scalar(self, vals=None) -> complex:  # reference-API alias
        if vals is not None and not isinstance(vals, Mapping):
            vals = dict(vals)
        return self.evaluate(vals)


def _one_plus_omega(k: int) -> ExactDyadic:
    """Exact (1 + w^k) in Z[w]."""
    d = omega_pow_dyadic(k)
    return ExactDyadic(d.a + 1, d.b, d.c, d.d)
