"""Exact dyadic Z[w] arithmetic and symbolic Scalar semantics vs complex.

Mirrors the reference's dyadic test matrix (reference
``test/unit/utils/test_dyadic.py``).
"""

import cmath
import math
from fractions import Fraction

import numpy as np
import pytest

from tsim_tpu_torch.zx.scalar import ExactDyadic, Scalar, omega_pow_dyadic

W = cmath.exp(1j * math.pi / 4)


def rand_dyadic(rng):
    return ExactDyadic(*(int(x) for x in rng.integers(-9, 10, size=4)))


class TestExactDyadic:
    def test_omega_powers(self):
        for k in range(16):
            assert cmath.isclose(
                omega_pow_dyadic(k).to_complex(), W**k, abs_tol=1e-12
            )

    @pytest.mark.parametrize("seed", range(8))
    def test_mul_matches_complex(self, seed):
        rng = np.random.default_rng(seed)
        a, b = rand_dyadic(rng), rand_dyadic(rng)
        assert cmath.isclose(
            (a * b).to_complex(), a.to_complex() * b.to_complex(), abs_tol=1e-9
        )

    def test_mul_omega_pow_matches(self):
        rng = np.random.default_rng(3)
        a = rand_dyadic(rng)
        for k in range(8):
            assert cmath.isclose(
                a.mul_omega_pow(k).to_complex(),
                a.to_complex() * W**k,
                abs_tol=1e-9,
            )

    def test_zero(self):
        assert ExactDyadic(0, 0, 0, 0).is_zero()
        assert not ExactDyadic(0, 1, 0, 0).is_zero()
        assert (ExactDyadic(0, 0, 0, 0) * ExactDyadic(3, 1, 4, 1)).is_zero()


class TestScalar:
    def test_power_and_phase(self):
        s = Scalar()
        s.add_power(3)
        s.add_phase(Fraction(1, 4))
        want = 2 ** 1.5 * cmath.exp(1j * math.pi / 4)
        assert cmath.isclose(s.evaluate({}), want, abs_tol=1e-12)

    def test_add_node_dyadic_closed_form(self):
        s = Scalar()
        s.add_node(Fraction(1, 4))
        assert cmath.isclose(s.evaluate({}), 1 + W, abs_tol=1e-12)
        assert not s.phasenodes  # folded into the exact prefactor

    def test_add_node_pi_is_zero(self):
        s = Scalar()
        s.add_node(Fraction(1))
        assert s.is_zero

    def test_add_node_param_dependent(self):
        s = Scalar()
        s.add_node(Fraction(1, 4), ["e0"])
        assert cmath.isclose(s.evaluate({"e0": 0}), 1 + W, abs_tol=1e-12)
        assert cmath.isclose(s.evaluate({"e0": 1}), 1 - W, abs_tol=1e-12)

    def test_pi_var_and_pairs(self):
        s = Scalar()
        s.add_pi_var(["e0"])
        s.add_pi_pair(frozenset({"e0"}), frozenset({"e1"}))
        assert s.evaluate({"e0": 0, "e1": 1}) == pytest.approx(1)
        assert s.evaluate({"e0": 1, "e1": 0}) == pytest.approx(-1)
        assert s.evaluate({"e0": 1, "e1": 1}) == pytest.approx(1)

    def test_halfpi(self):
        s = Scalar()
        s.add_halfpi(1, ["e0"])
        assert cmath.isclose(s.evaluate({"e0": 1}), 1j, abs_tol=1e-12)
        assert cmath.isclose(s.evaluate({"e0": 0}), 1, abs_tol=1e-12)

    def test_mul_combines(self):
        a = Scalar()
        a.add_power(1)
        a.add_node(Fraction(3, 4), ["e0"])
        b = Scalar()
        b.add_phase(Fraction(1, 2))
        b.add_pi_var(["e1"])
        a.mul(b)
        vals = {"e0": 1, "e1": 1}
        want = (
            math.sqrt(2)
            * (1 + cmath.exp(1j * math.pi * (0.75 + 1)))
            * 1j
            * -1
        )
        assert cmath.isclose(a.evaluate(vals), want, abs_tol=1e-12)

    @pytest.mark.parametrize("seed", range(4))
    def test_conjugate_matches_complex(self, seed):
        rng = np.random.default_rng(seed)
        s = Scalar()
        s.add_power(int(rng.integers(-3, 4)))
        s.add_phase(Fraction(int(rng.integers(0, 8)), 4))
        s.add_node(Fraction(int(rng.integers(0, 8)), 4), ["e0"])
        s.add_halfpi(int(rng.integers(1, 4)), ["e1"])
        s.add_phase_pair(
            int(rng.integers(0, 8)), int(rng.integers(0, 8)), ["e0"], ["e1"]
        )
        c = s.conjugate()
        for vals in ({"e0": 0, "e1": 0}, {"e0": 1, "e1": 0}, {"e0": 1, "e1": 1}):
            assert cmath.isclose(
                c.evaluate(vals), s.evaluate(vals).conjugate(), abs_tol=1e-9
            )


class TestProjectorNodeDedup:
    """Integer-phase nodes 1 +/- (-1)^parity are idempotent projectors (up
    to a factor 2); add_node canonicalizes them on insertion."""

    @pytest.mark.parametrize("ph", [Fraction(0), Fraction(1)])
    def test_duplicate_collapses(self, ph):
        s = Scalar()
        s.add_node(ph, ["e0"])
        t = s.copy()
        t.add_node(ph, ["e0"])
        assert len(t.phasenodes) == 1
        for e0 in (0, 1):
            assert cmath.isclose(
                t.evaluate({"e0": e0}),
                s.evaluate({"e0": e0}) ** 2,
                abs_tol=1e-12,
            )

    def test_opposite_phase_annihilates(self):
        s = Scalar()
        s.add_node(Fraction(0), ["e0"])
        s.add_node(Fraction(1), ["e0"])
        assert s.is_zero

    def test_different_params_kept(self):
        s = Scalar()
        s.add_node(Fraction(0), ["e0"])
        s.add_node(Fraction(0), ["e1"])
        assert len(s.phasenodes) == 2

    def test_quarter_phase_not_touched(self):
        s = Scalar()
        s.add_node(Fraction(1, 4), ["e0"])
        s.add_node(Fraction(1, 4), ["e0"])
        assert len(s.phasenodes) == 2

    def test_mul_dedups_across_product(self):
        a = Scalar()
        a.add_node(Fraction(0), ["e0"])
        b = Scalar()
        b.add_node(Fraction(0), ["e0"])
        a.mul(b)
        assert len(a.phasenodes) == 1
        for e0 in (0, 1):
            want = (1 + (-1) ** e0) ** 2
            assert cmath.isclose(a.evaluate({"e0": e0}), want, abs_tol=1e-12)

    def test_mul_self_alias_terminates(self):
        s = Scalar()
        s.add_node(Fraction(1, 4), ["e0"])
        s.mul(s)  # must not loop: add_node appends to the aliased lists
        assert len(s.phasenodes) == 2
