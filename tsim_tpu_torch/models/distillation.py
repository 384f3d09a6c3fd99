"""Magic state distillation / cultivation benchmark circuits.

The reference's headline benchmarks (reference ``BASELINE.md``): 5-qubit
logical distillation, its [[7,1,3]] Steane-encoded 35-qubit version (d=3
15-to-1) and the [[17,1,5]]-encoded 85-qubit version (d=5).
"""

from __future__ import annotations

import numpy as np

from ..circuit import Circuit
from ..utils.encoder import ColorEncoder5, SteaneEncoder

DISTILLATION_ANGLE = float(-np.arccos(np.sqrt(1.0 / 3.0)) / np.pi)


def logical_distillation_circuit(
    p: float = 0.05,
    noise: float | None = None,
    angle: float = DISTILLATION_ANGLE,
) -> Circuit:
    """5-qubit distillation: prepare noisy T-ish states, distill, measure.

    Post-select on syndromes [1, 0, 1, 1]; output bit 0 is the distilled
    state infidelity indicator.
    """
    noise = p / 5 if noise is None else noise
    nl1 = f"DEPOLARIZE1({noise})" if noise else "# no noise"
    text = f"""
        R 0 1 2 3 4
        R_X({angle}) 0 1 2 3 4
        T_DAG 0 1 2 3 4
        DEPOLARIZE1({p}) 0 1 2 3 4

        {nl1 + ' 0 1 2 3 4' if noise else ''}
        SQRT_X 0 1 4
        CZ 0 1 2 3
        {f'DEPOLARIZE2({noise}) 0 1 2 3' if noise else ''}
        SQRT_Y 0 3
        CZ 0 2 3 4
        {f'DEPOLARIZE2({noise}) 0 2 3 4' if noise else ''}
        TICK
        SQRT_X_DAG 0
        CZ 0 4 1 3
        {f'DEPOLARIZE2({noise}) 0 4 1 3' if noise else ''}
        TICK
        SQRT_X_DAG 0 1 2 3 4

        T 0
        R_X({-angle}) 0

        M 0 1 2 3 4
    """
    return Circuit(text)


def _encoded_distillation(
    encoder, p: float, noise: float, angle: float, basis: str = "Z"
) -> Circuit:
    encoder.initialize(
        f"""
        R 0 1 2 3 4
        R_X({angle}) 0 1 2 3 4
        T_DAG 0 1 2 3 4
        DEPOLARIZE1({p}) 0 1 2 3 4
        """,
    )
    noise_1 = f"DEPOLARIZE1({noise})" if noise else None
    noise_2 = f"DEPOLARIZE2({noise})" if noise else None

    def n1(targets):
        return f"{noise_1} {targets}\n" if noise_1 else ""

    def n2(targets):
        return f"{noise_2} {targets}\n" if noise_2 else ""

    body = (
        "SQRT_X 0 1 4\n" + n1("0 1 4")
        + "CZ 0 1 2 3\n" + n2("0 1 2 3")
        + "SQRT_Y 0 3\n" + n1("0 3")
        + "CZ 0 2 3 4\n" + n2("0 2 3 4")
        + "TICK\n"
        + "SQRT_X_DAG 0\n" + n1("0")
        + "CZ 0 4\n" + n2("0 4")
        + "TICK\n"
        + "CZ 1 3\n" + n2("1 3")
        + "TICK\n"
        + "SQRT_X_DAG 0 1 2 3 4\n" + n1("0 1 2 3 4")
        + ("H 0\n" if basis == "X" else "H_YZ 0\n" if basis == "Y" else "")
        + """M 0 1 2 3 4
DETECTOR rec[-5]
DETECTOR rec[-4]
DETECTOR rec[-3]
DETECTOR rec[-2]
DETECTOR rec[-1]
OBSERVABLE_INCLUDE(0) rec[-5]
OBSERVABLE_INCLUDE(1) rec[-4]
OBSERVABLE_INCLUDE(2) rec[-3]
OBSERVABLE_INCLUDE(3) rec[-2]
OBSERVABLE_INCLUDE(4) rec[-1]
"""
    )
    encoder.encode_transversally(body)
    return encoder.circuit


def distillation_d3(
    p: float = 0.05, noise: float | None = None, basis: str = "Z",
    angle: float = DISTILLATION_ANGLE,
) -> Circuit:
    """35-qubit d=3 15-to-1 distillation ([[7,1,3]] Steane-encoded)."""
    noise = p / 10 if noise is None else noise
    return _encoded_distillation(SteaneEncoder(), p, noise, angle, basis)


def distillation_d5(
    p: float = 0.05, noise: float | None = None, basis: str = "Z",
    angle: float = DISTILLATION_ANGLE,
) -> Circuit:
    """85-qubit d=5 distillation ([[17,1,5]] color-code encoded)."""
    noise = p / 10 if noise is None else noise
    return _encoded_distillation(ColorEncoder5(), p, noise, angle, basis)
