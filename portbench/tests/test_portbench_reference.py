"""The plain reference on small circuits: distributions worked out by
hand, the noiseless cultivation circuits, and the port's CPU sampler."""

import math

import pytest

from portbench import judge
from portbench.reference.density import bf16_rounding, output_distribution
from portbench.reference.stim_text import layout, parse


def dist(text, **kw):
    q, lay = output_distribution(text, **kw)
    return q, lay


def test_a_hadamard_measured_is_a_fair_coin():
    q, lay = dist("H 0\nM 0\nDETECTOR rec[-1]")
    assert lay.num_outputs == 1 and q == pytest.approx([0.5, 0.5])


def test_flips_and_channels():
    assert dist("X_ERROR(0.1) 0\nM 0\nDETECTOR rec[-1]")[0][1] == pytest.approx(0.1)
    assert dist("DEPOLARIZE1(0.3) 0\nM 0\nDETECTOR rec[-1]")[0][1] == pytest.approx(0.2)
    assert dist("M(0.25) 0\nDETECTOR rec[-1]")[0][1] == pytest.approx(0.25)
    assert dist("RX 0\nZ_ERROR(0.1) 0\nMX 0\nDETECTOR rec[-1]")[0][1] == pytest.approx(0.1)
    # DEPOLARIZE2: 8 of the 15 Paulis flip the first qubit's Z readout.
    assert dist("DEPOLARIZE2(0.15) 0 1\nM 0\nDETECTOR rec[-1]")[0][1] == pytest.approx(0.08)


def test_bell_pair_parities_and_mpp():
    q, _ = dist("H 0\nCX 0 1\nM 0 1\nDETECTOR rec[-1] rec[-2]\nOBSERVABLE_INCLUDE(0) rec[-1]")
    assert q == pytest.approx([0.5, 0, 0.5, 0])  # parity 0 always, observable a coin
    q, _ = dist("H 0\nCX 0 1\nMPP X0*X1 Z0*Z1\nDETECTOR rec[-2]\nDETECTOR rec[-1]")
    assert q[0] == pytest.approx(1.0)
    q, _ = dist("H 0\nCX 0 1\nMPP(0.1) X0*X1\nDETECTOR rec[-1]")
    assert q[1] == pytest.approx(0.1)


def test_t_gates_and_the_magic_state_readout():
    # T|+> read in X: P(1) = (1 - cos(pi/4)) / 2
    q, _ = dist("RX 0\nT 0\nMX 0\nDETECTOR rec[-1]")
    assert q[1] == pytest.approx((1 - math.cos(math.pi / 4)) / 2)
    q, _ = dist("RX 0\nT 0\nT_DAG 0\nS 0\nS_DAG 0\nSQRT_Y 0\nSQRT_Y_DAG 0\nMX 0\nDETECTOR rec[-1]")
    assert q[1] == pytest.approx(0.0, abs=1e-12)
    q, _ = dist("R 0\nSQRT_Y 0\nMX 0\nDETECTOR rec[-1]")  # SQRT_Y: Z -> X
    assert q[0] == pytest.approx(1.0)


def test_a_reset_qubit_is_reused():
    q, _ = dist("H 0\nM 0\nR 0\nM 0\nDETECTOR rec[-1]\nDETECTOR rec[-2]")
    assert q == pytest.approx([0.5, 0, 0.5, 0])


def test_layout_counts_records_and_cancels_repeats():
    lay = layout(parse("M 0 1\nDETECTOR rec[-1] rec[-2]\nDETECTOR rec[-1] rec[-1]\nOBSERVABLE_INCLUDE(1) rec[-2]"))
    assert (lay.num_detectors, lay.num_observables) == (2, 2)
    assert lay.outputs_of_measurement == [[0, 3], [0]]


def test_unknown_instructions_are_refused():
    with pytest.raises(ValueError):
        parse("REPEAT 3 {\nH 0\n}")
    with pytest.raises(ValueError):
        parse("CCZ 0 1 2")


@pytest.mark.parametrize("checks", [1, 2])
def test_noiseless_cultivation(checks):
    from portbench import cells

    text = cells.load_config(f"cultivation_d3_c{checks}").circuit_text
    noiseless = "\n".join(l for l in text.splitlines()
                          if not l.startswith(("DEPOLARIZE", "Z_ERROR"))).replace("MPP(0.0001)", "MPP")
    q, lay = dist(noiseless)
    nd = lay.num_detectors
    det = q.reshape(-1, 1 << nd).sum(axis=0)
    assert det[0] == pytest.approx(1.0)  # every detector is deterministic 0
    assert q.reshape(-1, 1 << nd)[1].sum() == pytest.approx((1 - 1 / math.sqrt(2)) / 2)
    q_noisy, _ = dist(text)
    assert q_noisy.sum() == pytest.approx(1.0) and q_noisy.min() > -1e-15


def test_bf16_rounding_moves_the_distribution():
    text = "RX 0\nT 0\nDEPOLARIZE1(0.001) 0\nMX 0\nDETECTOR rec[-1]"
    exact, _ = dist(text)
    rough, _ = dist(text, rounding=bf16_rounding)
    assert abs(rough[1] - exact[1]) > 1e-5


def test_the_port_samples_the_reference_distribution_on_the_cpu():
    from tsim_tpu_torch.models import cultivation_logical

    circuit = cultivation_logical(p=0.01, checks=2)
    q, lay = output_distribution(str(circuit))
    rows = circuit.compile_detector_sampler(seed=11, device="cpu").sample(1 << 15, append_observables=True)
    hist = judge.histogram([rows], lay.num_outputs)
    checks = judge.checks_of(hist, q, lay.num_outputs, lay.num_detectors, False, 0)
    assert checks["max_abs_z"]["events"] > 3
    assert checks["max_abs_z"]["value"] < judge.MAX_ABS_Z_LIMIT
