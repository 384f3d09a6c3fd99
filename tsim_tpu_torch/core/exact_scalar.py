"""Batched exact arithmetic in Z[w] * 2^power, w = e^{i pi/4} (counterpart of
``tsim_tpu/core/exact_scalar.py``).

A value is ``(c0 + c1 w + c2 w^2 + c3 w^3) * 2^power`` with int32
coefficients, the component axis leading: ``coeffs`` is ``(4,) + shape``
and ``power`` is ``shape``. Products and sums stay exact; the one float
conversion happens at the end (:func:`exact_magnitude`).

Reductions run as balanced trees with one reduce step per level, which
divides common factors of two into ``power`` and keeps the coefficients
small. The semantics follow ``tsim_tpu`` step for step, down to the
all-zero guard of the reduce step and the shift of the aligned add,
clipped at 30.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

INV_SQRT2 = 0.7071067811865476


def _mul_coeffs(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """Product of (4, ...) coefficient tensors in Z[w] (w^4 = -1)."""
    a1, b1, c1, e1 = d1[0], d1[1], d1[2], d1[3]
    a2, b2, c2, e2 = d2[0], d2[1], d2[2], d2[3]
    return torch.stack(
        [
            a1 * a2 - b1 * e2 - c1 * c2 - e1 * b2,
            a1 * b2 + b1 * a2 - c1 * e2 - e1 * c2,
            a1 * c2 + b1 * b2 + c1 * a2 - e1 * e2,
            a1 * e2 + b1 * c2 + c1 * b2 + e1 * a2,
        ]
    ).to(d1.dtype)


def _reduce_step(power: torch.Tensor, coeffs: torch.Tensor):
    """Halve every coefficient where all four are even and not all zero."""
    reducible = ((coeffs & 1) == 0).all(dim=0) & (coeffs != 0).any(dim=0)
    coeffs = torch.where(reducible[None], coeffs >> 1, coeffs)
    power = torch.where(reducible, power + 1, power)
    return power, coeffs


def _mul_with_power(x, y):
    p1, c1 = x
    p2, c2 = y
    return _reduce_step(p1 + p2, _mul_coeffs(c1, c2))


def _add_with_power(x, y):
    """Aligned add: shift to the smaller power, the shift clipped at 30."""
    p1, c1 = x
    p2, c2 = y
    one = torch.ones_like(p1)
    s1 = torch.bitwise_left_shift(one, torch.clamp(p1 - p2, 0, 30))[None]
    s2 = torch.bitwise_left_shift(one, torch.clamp(p2 - p1, 0, 30))[None]
    return _reduce_step(torch.minimum(p1, p2), c1 * s1 + c2 * s2)


def _reduce_tree(power, coeffs, op, value_axis: int):
    """Balanced-tree reduction of ``op`` along ``value_axis`` of ``power``
    (axis ``value_axis + 1`` of ``coeffs``)."""
    power = torch.movedim(power, value_axis, 0)
    coeffs = torch.movedim(coeffs, value_axis + 1, 1)
    while power.shape[0] > 1:
        n = power.shape[0]
        half = n // 2
        p, c = op(
            (power[:half], coeffs[:, :half]),
            (power[half : 2 * half], coeffs[:, half : 2 * half]),
        )
        if n % 2:
            p = torch.cat([p, power[-1:]], dim=0)
            c = torch.cat([c, coeffs[:, -1:]], dim=1)
        power, coeffs = p, c
    return power[0], coeffs[:, 0]


def exp2_int(power: torch.Tensor) -> torch.Tensor:
    """Exactly ``2^power`` in float32 for an int32 tensor, on any device.

    Built from exponent bits as two normal factors, so the product rounds
    only where the result leaves the float32 range (to a denormal, 0 or
    inf). ``torch.exp2`` and XLA's ``exp2`` are not guaranteed exact on
    integers (XLA's CPU ``exp2`` is off by up to 4e-6 relative).
    """
    p = torch.clamp(power.to(torch.int32), -252, 254)
    h = torch.div(p, 2, rounding_mode="floor")

    def factor(e):
        return torch.bitwise_left_shift(e + 127, 23).view(torch.float32)

    return factor(h) * factor(p - h)


def coeffs_to_real_imag(coeffs: torch.Tensor):
    """(re, im) float32 of (4, ...) coefficients, without the power."""
    c = coeffs.to(torch.float32)
    re = c[0] + (c[1] - c[3]) * INV_SQRT2
    im = c[2] + (c[1] + c[3]) * INV_SQRT2
    return re, im


def exact_magnitude(coeffs: torch.Tensor, power: torch.Tensor) -> torch.Tensor:
    """``|c| * 2^power`` in float32: the one float conversion of an exact value."""
    re, im = coeffs_to_real_imag(coeffs)
    return torch.sqrt(re * re + im * im) * exp2_int(power)


@dataclass
class ExactScalarArray:
    """Exact Z[w] scalars with power-of-two exponents.

    ``coeffs`` has shape ``(4,) + value_shape`` (int32); ``power`` has
    ``value_shape`` (int32).
    """

    coeffs: torch.Tensor
    power: torch.Tensor

    @staticmethod
    def from_coeffs(coeffs: torch.Tensor, power: torch.Tensor | None = None) -> "ExactScalarArray":
        if power is None:
            power = torch.zeros(coeffs.shape[1:], dtype=torch.int32, device=coeffs.device)
        return ExactScalarArray(coeffs=coeffs, power=power)

    @staticmethod
    def from_coeffs_last(coeffs_last: torch.Tensor, power: torch.Tensor | None = None) -> "ExactScalarArray":
        """From a (..., 4) trailing-axis table (the host layout of floatfactors)."""
        return ExactScalarArray.from_coeffs(torch.movedim(coeffs_last, -1, 0), power)

    def __mul__(self, other: "ExactScalarArray") -> "ExactScalarArray":
        return ExactScalarArray(
            coeffs=_mul_coeffs(self.coeffs, other.coeffs), power=self.power + other.power
        )

    def _empty(self, axis: int, identity: int) -> "ExactScalarArray":
        shape = self.power.shape[:axis] + self.power.shape[axis + 1 :]
        c = torch.zeros((4,) + shape, dtype=self.coeffs.dtype, device=self.coeffs.device)
        c[0] = identity
        return ExactScalarArray.from_coeffs(c)

    def sum(self, axis: int = -1) -> "ExactScalarArray":
        axis = axis % self.power.dim()
        if self.power.shape[axis] == 0:
            return self._empty(axis, 0)
        p, c = _reduce_tree(self.power, self.coeffs, _add_with_power, axis)
        return ExactScalarArray(coeffs=c, power=p)

    def prod(self, axis: int = -1) -> "ExactScalarArray":
        axis = axis % self.power.dim()
        if self.power.shape[axis] == 0:
            return self._empty(axis, 1)
        p, c = _reduce_tree(self.power, self.coeffs, _mul_with_power, axis)
        return ExactScalarArray(coeffs=c, power=p)

    def to_real_imag(self):
        """(re, im) float32 including the ``2^power`` scale."""
        re, im = coeffs_to_real_imag(self.coeffs)
        scale = exp2_int(self.power)
        return re * scale, im * scale

    def abs(self) -> torch.Tensor:
        return exact_magnitude(self.coeffs, self.power)
