"""Shorthand <-> stim program-text rewriting."""

import numpy as np

import tsim_tpu_torch
from tsim_tpu_torch.utils.program_text import (
    controlled_gate_decomposition_lines,
    shorthand_to_stim,
    stim_to_shorthand,
)


def test_t_family_tagging():
    out = shorthand_to_stim("T 0\nT_DAG 1")
    assert "S[T] 0" in out and "S_DAG[T] 1" in out


def test_rotation_tagging():
    out = shorthand_to_stim("R_Z(0.33) 0")
    assert "I[R_Z(theta=0.33*pi)] 0" in out


def test_u3_tagging():
    out = shorthand_to_stim("U3(0.1, 0.2, 0.3) 2")
    assert "I[U3" in out and "2" in out


def test_round_trip_stability():
    text = "H 0\nT 0\nR_Z(0.25) 1\nTPP X0*Z1\nM 0 1"
    stim_text = shorthand_to_stim(text)
    back = stim_to_shorthand(stim_text)
    # Second conversion is a fixed point.
    assert shorthand_to_stim(back) == stim_text


def test_ccz_expansion_is_unitary_equal():
    # The CCZ Clifford+T expansion must equal the exact 3-qubit CCZ.
    c = tsim_tpu_torch.Circuit("CCZ 0 1 2")
    mat = c.to_matrix()
    want = np.eye(8, dtype=complex)
    want[7, 7] = -1
    # Equal up to global phase.
    k = np.flatnonzero(np.abs(mat) > 1e-9)[0]
    phase = mat.flat[k] / want.flat[k]
    np.testing.assert_allclose(mat, want * phase, atol=1e-7)


def test_ccx_expansion_is_unitary_equal():
    c = tsim_tpu_torch.Circuit("CCX 0 1 2")
    mat = c.to_matrix()
    want = np.eye(8, dtype=complex)[:, [0, 1, 2, 3, 4, 5, 7, 6]]
    k = np.flatnonzero(np.abs(mat) > 1e-9)[0]
    phase = mat.flat[k] / want.flat[k]
    np.testing.assert_allclose(mat, want * phase, atol=1e-7)


def test_decomposition_lines_preserve_comments_and_tags():
    lines = controlled_gate_decomposition_lines("CCZ", 0, 1, 2)
    assert len(lines) >= 10
    assert any("T" in ln for ln in lines)
