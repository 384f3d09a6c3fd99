"""Clifford-rotation expansion and transversal encoders of the port
(``tsim_tpu_torch/utils/``), mirrored from
``tests/unit/utils/test_clifford_and_encoder.py``.

The original reads the encoders' noiseless detectors from the Clifford
frame sampler; here the port's ``FrameSampler`` reads them, and the port's
own compiler also proves them deterministic (every detector a constant
direct output of the compiled program). Every diagram type renders, and its
text equals tsim_tpu's.
"""

import numpy as np
import pytest

import tsim_tpu
import tsim_tpu_torch
from tests.test_torch_parse import noiseless_outputs
from tsim_tpu_torch.utils.clifford import (
    expand_clifford_rotations,
    is_clifford,
    parametric_to_clifford_gates,
)
from tsim_tpu_torch.stim_core.frame import FrameSampler
from tsim_tpu_torch.utils.encoder import ColorEncoder5, SteaneEncoder


def test_half_pi_rotations_map_to_clifford_gates():
    from fractions import Fraction

    assert parametric_to_clifford_gates("R_Z", {"theta": Fraction(1, 2)}) == ["S"]
    assert parametric_to_clifford_gates("R_Z", {"theta": Fraction(3, 2)}) == ["S_DAG"]
    assert parametric_to_clifford_gates("R_Z", {"theta": Fraction(1)}) == ["Z"]
    assert parametric_to_clifford_gates("R_Z", {"theta": Fraction(1, 4)}) is None


def test_is_clifford():
    assert is_clifford(tsim_tpu_torch.Circuit("H 0\nS 0\nCZ 0 1\nM 0")._stim_circ)
    assert not is_clifford(tsim_tpu_torch.Circuit("T 0")._stim_circ)
    assert is_clifford(tsim_tpu_torch.Circuit("R_Z(0.5) 0")._stim_circ)
    assert not is_clifford(tsim_tpu_torch.Circuit("R_Z(0.3) 0")._stim_circ)


def test_expand_clifford_rotations_matrix_equal():
    c = tsim_tpu_torch.Circuit("R_Z(0.5) 0\nR_X(1.5) 0")
    expanded = expand_clifford_rotations(c._stim_circ)
    a = c.to_matrix()
    b = tsim_tpu_torch.Circuit(str(expanded)).to_matrix()
    k = np.flatnonzero(np.abs(a) > 1e-9)[0]
    np.testing.assert_allclose(a, b * (a.flat[k] / b.flat[k]), atol=1e-7)


def _encoder_detectors_silent(encoder, logical):
    encoder.initialize("R 0")
    encoder.encode_transversally(logical)
    circ = encoder.circuit
    assert is_clifford(circ._stim_circ)
    dets = noiseless_outputs(circ)[: circ.num_detectors]
    assert dets.shape[0] > 0
    assert not dets.any()
    _, sampled, _ = FrameSampler(circ, seed=0).sample(256)
    assert sampled.shape[1] == dets.shape[0]
    assert not sampled.any()


def test_steane_encoder_noiseless_detectors_silent():
    # Logical identity + transversal stabilizer measurement: every detector
    # compares a stabilizer generator against its deterministic value.
    enc = SteaneEncoder()
    _encoder_detectors_silent(
        enc,
        """
        MPP Z0
        DETECTOR rec[-1]
        """,
    )


def test_color_code_encoder_noiseless_detectors_silent():
    enc = ColorEncoder5()
    _encoder_detectors_silent(
        enc,
        """
        MPP Z0
        DETECTOR rec[-1]
        """,
    )


def test_steane_logical_observable_deterministic():
    enc = SteaneEncoder()
    enc.initialize("R 0")
    enc.encode_transversally(
        "X 0\nMPP Z0\nOBSERVABLE_INCLUDE(0) rec[-1]"
    )
    obs = noiseless_outputs(enc.circuit)[enc.circuit.num_detectors :]
    assert obs.shape[0] == 1
    assert obs.all()  # logical X flips the logical Z outcome deterministically
    _, _, sampled = FrameSampler(enc.circuit, seed=1).sample(256)
    assert sampled.shape[1] == 1
    assert sampled.all()


DIAGRAM_TEXT = "H 0\nTICK\nCNOT 0 1\nT 1\nTICK\nM 0 1\nDETECTOR rec[-1]"
SURFACE_TEXT = str(tsim_tpu_torch.models.rotated_surface_code_memory_z(3, 2, after_clifford_depolarization=0.01))


@pytest.mark.parametrize("text", [DIAGRAM_TEXT, SURFACE_TEXT], ids=["small", "surface_d3"])
@pytest.mark.parametrize("ty", ["timeline-svg", "timeslice-svg", "pyzx", "pyzx-dets", "pyzx-meas"])
def test_all_diagram_types_render(ty, text):
    svg = str(tsim_tpu_torch.Circuit(text).diagram(ty))
    assert svg.startswith("<svg"), ty
    assert svg == str(tsim_tpu.Circuit(text).diagram(ty))


def test_unknown_diagram_type_raises():
    with pytest.raises(ValueError, match="Unknown diagram type"):
        tsim_tpu_torch.Circuit(DIAGRAM_TEXT).diagram("nope")
