"""Stim-dialect circuit engine tests (parser, counters, structural ops)."""

import pytest

from tsim_tpu_torch.stim_core import (
    Circuit,
    CircuitInstruction,
    CircuitRepeatBlock,
    target_rec,
    target_x,
)


def test_parse_roundtrip():
    text = """H 0
CNOT 0 1
X_ERROR(0.3) 0
REPEAT 3 {
    M 0 1
    DETECTOR rec[-1] rec[-2]
}
MPP X0*Y1 Z0
SPP[T] X0*X1
S[T] 0
OBSERVABLE_INCLUDE(0) rec[-1]
I[R_Z(theta=0.3*pi)] 0
M !1"""
    c = Circuit(text)
    assert Circuit(str(c)) == c
    assert c.num_measurements == 9
    assert c.num_detectors == 3
    assert c.num_observables == 1
    assert c.num_qubits == 2


def test_counters_heralds_and_mpad():
    c = Circuit("HERALDED_ERASE(0.1) 0 1\nMPAD 0 1 0\nMXX 0 1 2 3")
    assert c.num_measurements == 2 + 3 + 2
    assert c.num_qubits == 4


def test_fusing_and_eq():
    a = Circuit("H 0\nH 1")
    b = Circuit("H 0 1")
    assert a == b
    assert len(a) == 1
    assert not Circuit("X_ERROR(0.1) 0") == Circuit("X_ERROR(0.2) 0")
    assert Circuit("X_ERROR(0.1) 0").approx_equals(Circuit("X_ERROR(0.1001) 0"), atol=0.01)
    # detectors never fuse
    assert len(Circuit("DETECTOR rec[-1]\nDETECTOR rec[-1]")) == 2


def test_repeat_flatten():
    c = Circuit("REPEAT 2 {\nREPEAT 3 {\nM 0\n}\n}")
    assert c.num_measurements == 6
    f = c.flattened()
    assert f.num_measurements == 6
    assert all(not isinstance(i, CircuitRepeatBlock) for i in f)


def test_inverse():
    c = Circuit("H 0\nS 1\nSQRT_X 0\nCX 0 1\nT_DAG_MARK 0" .replace("T_DAG_MARK", "S_DAG"))
    inv = c.inverse()
    assert str(inv) == "S 0\nCX 0 1\nSQRT_X_DAG 0\nS_DAG 1\nH 0"


def test_inverse_tags_preserved():
    c = Circuit("S[T] 0\nSPP[T] X0*X1")
    inv = c.inverse()
    items = list(inv)
    assert items[0].name == "SPP_DAG" and items[0].tag == "T"
    assert items[1].name == "S_DAG" and items[1].tag == "T"


def test_targets():
    c = Circuit("CX rec[-1] 1\nM !0")
    (cx, m) = list(c)
    assert cx.targets[0].is_measurement_record_target
    assert cx.targets[0].value == -1
    assert m.targets[0].is_inverted_result_target


def test_target_groups():
    c = Circuit("MPP X0*Y1 Z2\nCZ 0 1 2 3")
    mpp, cz = list(c)
    assert [[str(t) for t in grp] for grp in mpp.target_groups()] == [["X0", "Y1"], ["Z2"]]
    assert [[t.value for t in grp] for grp in cz.target_groups()] == [[0, 1], [2, 3]]


def test_errors():
    with pytest.raises(ValueError, match="Gate not found"):
        Circuit("NOT_A_GATE 0")
    with pytest.raises(ValueError, match="parens arguments"):
        Circuit("X_ERROR 0")
    with pytest.raises(ValueError, match="parens arguments"):
        Circuit("PAULI_CHANNEL_1(0.1) 0")
    with pytest.raises(ValueError):
        Circuit("H X0")
    with pytest.raises(ValueError):
        Circuit("REPEAT 2 {\nH 0")


def test_without_noise():
    c = Circuit("H 0\nX_ERROR(0.1) 0\nM(0.02) 0\nHERALDED_ERASE(0.1) 1")
    wn = c.without_noise()
    assert wn.num_measurements == c.num_measurements
    assert str(wn) == "H 0\nM 0\nMPAD 0"


def test_mul_and_slice():
    c = Circuit("H 0\nM 0")
    c3 = c * 3
    assert c3.num_measurements == 3
    assert isinstance(c3[0], CircuitRepeatBlock)
    assert (c + c).num_measurements == 2
    assert c[0:1] == Circuit("H 0")


def test_append_api():
    c = Circuit()
    c.append("H", [0, 1])
    c.append("X_ERROR", [0], 0.25)
    c.append("OBSERVABLE_INCLUDE", [target_rec(-1)], 0)
    c.append("SPP", [target_x(0)], tag="T")
    assert str(c) == "H 0 1\nX_ERROR(0.25) 0\nOBSERVABLE_INCLUDE(0) rec[-1]\nSPP[T] X0"


def test_correlated_error_rejects_combiners():
    # stim parity: E takes bare pauli targets, not products.
    import pytest

    from tsim_tpu_torch.stim_core import Circuit

    with pytest.raises(ValueError, match="combiners"):
        Circuit("E(0.1) X0*X1")
    with pytest.raises(ValueError, match="combiners"):
        Circuit("ELSE_CORRELATED_ERROR(0.1) Z0*Z1")
    # MPP/SPP still accept them.
    Circuit("MPP X0*X1")
    Circuit("SPP X0*Z1")
