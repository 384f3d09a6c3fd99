"""Parser edge cases of the port (``tsim_tpu_torch/core/parse.py``): tags,
Pauli algebra, targets, errors.

Mirrored from ``tests/unit/core/test_parse.py`` (the reference's parse test
matrix, reference ``test/unit/core/test_parse.py``, SURVEY.md section 4).
Where the original samples a Clifford circuit's detectors, which are then
deterministic, the port has no sampler for a program without components yet
(``ROADMAP.md`` item 1.8): their values are read from the port's compiled
program instead, where each must be a constant direct output.
"""

from fractions import Fraction

import numpy as np
import pytest

import tsim_tpu_torch
from tsim_tpu_torch.compile.pipeline import compile_program
from tsim_tpu_torch.core.graph_prep import prepare_graph
from tsim_tpu_torch.core.parse import (
    R_PAULI_MAX_QUBITS,
    _iter_pauli_products,
    parse_parametric_tag,
    parse_stim_circuit,
)
from tsim_tpu_torch.stim_core import Circuit as StimCircuit


def _instr(text):
    return StimCircuit(text)[0]


def noiseless_outputs(circuit) -> np.ndarray:
    """The detectors' then observables' values of a circuit whose every
    output compiles to a constant direct output (a Clifford circuit without
    noise), from the port's compiled program."""
    program = compile_program(prepare_graph(circuit, sample_detectors=True), mode="sequential")
    assert not program.components
    assert program.direct_const_mask.all()
    values = np.zeros(program.num_outputs, bool)
    values[program.output_order] = program.direct_flips
    return values


def _deterministic_detectors(circuit) -> np.ndarray:
    """(1, num_detectors) bool: the detectors as one sampled row."""
    return noiseless_outputs(circuit)[None, : circuit.num_detectors]


# ----------------------------------------------------------- parametric tags
class TestParametricTag:
    def test_rz_tag(self):
        gate, params = parse_parametric_tag(_instr("I[R_Z(theta=0.3*pi)] 0"))
        assert gate == "R_Z"
        # Non-dyadic angles canonicalize to the nearest 2^-40 dyadic
        # (exact Fraction arithmetic downstream stays int64-bounded).
        theta = params["theta"]
        assert abs(theta - Fraction(3, 10)) <= Fraction(1, 2**40)
        assert theta.denominator & (theta.denominator - 1) == 0

    def test_u3_tag_all_params(self):
        gate, params = parse_parametric_tag(
            _instr("I[U3(theta=0.5*pi, phi=-0.25*pi, lambda=1.5*pi)] 0")
        )
        assert gate == "U3"
        assert params == {
            "theta": Fraction(1, 2),
            "phi": Fraction(-1, 4),
            "lambda": Fraction(3, 2),
        }

    def test_scientific_notation(self):
        _, params = parse_parametric_tag(_instr("I[R_X(theta=1e-3*pi)] 0"))
        assert abs(params["theta"] - Fraction("0.001")) <= Fraction(1, 2**40)

    def test_negative_angle(self):
        _, params = parse_parametric_tag(_instr("I[R_Y(theta=-.75*pi)] 0"))
        assert params["theta"] == Fraction(-3, 4)

    def test_non_tag_returns_none(self):
        assert parse_parametric_tag(_instr("I[hello] 0")) is None
        assert parse_parametric_tag(_instr("I 0")) is None

    def test_unknown_gate_raises(self):
        with pytest.raises(ValueError, match="Unknown parametric gate"):
            parse_parametric_tag(_instr("I[R_W(theta=0.5*pi)] 0"))

    def test_missing_param_raises(self):
        with pytest.raises(ValueError, match="expected"):
            parse_parametric_tag(_instr("I[U3(theta=0.5*pi)] 0"))

    def test_extra_param_raises(self):
        with pytest.raises(ValueError, match="expected"):
            parse_parametric_tag(_instr("I[R_Z(theta=0.5*pi, phi=0.5*pi)] 0"))

    def test_malformed_value_raises(self):
        with pytest.raises(ValueError, match="Malformed"):
            parse_parametric_tag(_instr("I[R_Z(theta=abc*pi)] 0"))

    def test_missing_pi_suffix_raises(self):
        with pytest.raises(ValueError, match="Malformed"):
            parse_parametric_tag(_instr("I[R_Z(theta=0.5)] 0"))


# --------------------------------------------------------- Pauli product iter
def _products(text):
    return list(_iter_pauli_products(_instr(text)))


class TestPauliProducts:
    def test_single_product(self):
        [(paulis, invert)] = _products("MPP X0*Y1*Z2")
        assert paulis == [("X", 0), ("Y", 1), ("Z", 2)]
        assert not invert

    def test_multiple_products(self):
        prods = _products("MPP X0*X1 Z2*Z3")
        assert [p for p, _ in prods] == [
            [("X", 0), ("X", 1)],
            [("Z", 2), ("Z", 3)],
        ]

    def test_inverted_target_sets_invert(self):
        [(_, invert)] = _products("MPP !X0*X1")
        assert invert

    def test_double_inversion_cancels(self):
        [(_, invert)] = _products("MPP !X0*!X1")
        assert not invert

    def test_same_pauli_twice_cancels(self):
        [(paulis, invert)] = _products("MPP X0*X0*Z1")
        assert paulis == [("Z", 1)]
        assert not invert

    def test_xy_gives_minus_z_pair(self):
        # X*Y = iZ; a single repeat is anti-Hermitian.
        with pytest.raises(ValueError, match="anti-Hermitian"):
            _products("MPP X0*Y0")

    def test_xy_yx_sign(self):
        # (X0 Y0)(Y1 X1) = (iZ0)(-iZ1) = Z0 Z1, Hermitian, no inversion.
        [(paulis, invert)] = _products("MPP X0*Y0*Y1*X1")
        assert paulis == [("Z", 0), ("Z", 1)]
        assert not invert

    def test_xy_xy_gives_inverted(self):
        # (X0 Y0)(X1 Y1) = (iZ0)(iZ1) = -Z0 Z1.
        [(paulis, invert)] = _products("MPP X0*Y0*X1*Y1")
        assert paulis == [("Z", 0), ("Z", 1)]
        assert invert

    def test_sorted_by_qubit(self):
        [(paulis, _)] = _products("MPP Z5*X1*Y3")
        assert paulis == [("X", 1), ("Y", 3), ("Z", 5)]


# --------------------------------------------------------------- full parser
class TestParseStimCircuit:
    def test_sweep_bits_raise(self):
        c = tsim_tpu_torch.Circuit("CX sweep[0] 0\nM 0")
        with pytest.raises(NotImplementedError, match="[Ss]weep"):
            parse_stim_circuit(c.cast_to_stim())

    def test_shift_coords_skipped(self):
        c = tsim_tpu_torch.Circuit("SHIFT_COORDS(1, 2)\nH 0\nM 0")
        b = parse_stim_circuit(c.cast_to_stim())
        assert len(b.rec) == 1

    def test_observable_pauli_targets_raise(self):
        # Rejected at circuit construction (stim_core gate data).
        from tsim_tpu_torch import stim_core

        sc = StimCircuit("H 0\nM 0")
        with pytest.raises(ValueError, match="[Pp]auli"):
            sc.append("OBSERVABLE_INCLUDE", [stim_core.target_x(0)], 0)

    def test_unknown_gate_raises(self):
        with pytest.raises(ValueError):
            tsim_tpu_torch.Circuit("FOOBAR 0")

    def test_missing_observables_materialized(self):
        c = tsim_tpu_torch.Circuit("M 0\nOBSERVABLE_INCLUDE(2) rec[-1]")
        b = parse_stim_circuit(c.cast_to_stim())
        # Observables 0 and 1 are materialized as deterministic-zero spiders.
        assert sorted(b.observables_dict) == [0, 1, 2]

    def test_t_tag_dispatch(self):
        c = tsim_tpu_torch.Circuit("")
        c.append("T", [0])
        c.append("T_DAG", [0])
        b = parse_stim_circuit(c.cast_to_stim())
        from tsim_tpu_torch.zx.decompose import tcount

        assert tcount(b.graph) == 2

    def test_r_pauli_too_many_qubits(self):
        n = R_PAULI_MAX_QUBITS + 1
        prod = "*".join(f"X{q}" for q in range(n))
        c = tsim_tpu_torch.Circuit(f"SPP[R_PAULI(theta=0.3*pi)] {prod}")
        with pytest.raises(ValueError, match="at most"):
            parse_stim_circuit(c.cast_to_stim())

    def test_r_pauli_repeated_qubit_raises(self):
        c = tsim_tpu_torch.Circuit("SPP[R_PAULI(theta=0.3*pi)] X0*Z0")
        with pytest.raises(ValueError, match="distinct"):
            parse_stim_circuit(c.cast_to_stim())

    def test_correlated_error_chain_bits(self):
        c = tsim_tpu_torch.Circuit(
            "E(0.1) X0\nELSE_CORRELATED_ERROR(0.2) Y1\n"
            "ELSE_CORRELATED_ERROR(0.3) Z0 Z1\nM 0 1"
        )
        b = parse_stim_circuit(c.cast_to_stim())
        # One chain of 3 alternatives: one channel with 2^3 outcomes.
        assert len(b.channel_probs) == 1
        assert len(b.channel_probs[0]) == 8

    def test_separate_e_instructions_two_channels(self):
        c = tsim_tpu_torch.Circuit("E(0.1) X0\nE(0.2) Z0\nM 0")
        b = parse_stim_circuit(c.cast_to_stim())
        assert len(b.channel_probs) == 2

    def test_classically_controlled_gate(self):
        c = tsim_tpu_torch.Circuit("M 0\nCX rec[-1] 1\nM 1")
        b = parse_stim_circuit(c.cast_to_stim())
        assert len(b.rec) == 2

    def test_repeat_blocks_flattened(self):
        c = tsim_tpu_torch.Circuit("REPEAT 3 {\n H 0\n M 0\n}")
        b = parse_stim_circuit(c.cast_to_stim())
        assert len(b.rec) == 3

    def test_heralded_channels_add_records(self):
        c = tsim_tpu_torch.Circuit("HERALDED_ERASE(0.1) 0\nM 0")
        b = parse_stim_circuit(c.cast_to_stim())
        assert len(b.rec) == 2  # herald + measurement


# ------------------------------------------------------- correlated errors
class TestCorrelatedErrorStructure:
    def test_single_e_instruction_one_channel(self):
        b = parse_stim_circuit(tsim_tpu_torch.Circuit("E(0.1) X0\nM 0").cast_to_stim())
        assert len(b.channel_probs) == 1
        assert list(b.channel_probs[0]) == pytest.approx([0.9, 0.1])

    def test_y_error_bit_touches_x_and_z_spiders(self):
        # Y = XZ: the single error bit lands on two spiders (X and Z parts).
        b = parse_stim_circuit(tsim_tpu_torch.Circuit("Y_ERROR(0.1) 0\nM 0").cast_to_stim())
        g = b.graph
        carriers = [v for v in g.vertices() if "e0" in g.get_params(v)]
        assert len(carriers) == 2

    def test_error_vertices_carry_e_params(self):
        b = parse_stim_circuit(
            tsim_tpu_torch.Circuit("X_ERROR(0.2) 0\nZ_ERROR(0.3) 1\nM 0 1").cast_to_stim()
        )
        g = b.graph
        eparams = set()
        for v in g.vertices():
            eparams |= {p for p in g.get_params(v) if p.startswith("e")}
        assert eparams == {"e0", "e1"}

    def test_chain_spans_multiple_qubits(self):
        b = parse_stim_circuit(
            tsim_tpu_torch.Circuit("E(0.1) X0 X1 X2\nM 0 1 2").cast_to_stim()
        )
        assert len(b.channel_probs) == 1
        g = b.graph
        carriers = [v for v in g.vertices() if "e0" in g.get_params(v)]
        assert len(carriers) == 3

    def test_two_separate_chains_two_channels(self):
        b = parse_stim_circuit(
            tsim_tpu_torch.Circuit(
                "E(0.1) X0\nELSE_CORRELATED_ERROR(0.2) Z0\nE(0.3) X1\nM 0 1"
            ).cast_to_stim()
        )
        assert len(b.channel_probs) == 2
        assert len(b.channel_probs[0]) == 4  # 2-alternative chain
        assert len(b.channel_probs[1]) == 2

    def test_chain_probabilities_are_exclusive(self):
        b = parse_stim_circuit(
            tsim_tpu_torch.Circuit(
                "E(0.5) X0\nELSE_CORRELATED_ERROR(0.5) Z0\nM 0"
            ).cast_to_stim()
        )
        [probs] = b.channel_probs
        # P(first)=0.5, P(second)=0.5*0.5, P(neither)=0.25; one-hot encoding.
        assert probs.sum() == pytest.approx(1.0)
        assert sorted(probs, reverse=True)[:3] == pytest.approx([0.5, 0.25, 0.25])


# ---------------------------------------------------------- heralded noise
class TestHeraldedChannels:
    def test_heralded_erase_outcome_distribution(self):
        b = parse_stim_circuit(
            tsim_tpu_torch.Circuit("HERALDED_ERASE(0.2) 0\nM 0").cast_to_stim()
        )
        [probs] = b.channel_probs
        assert probs[0] == pytest.approx(0.8)
        assert sorted(probs[1:], reverse=True)[:4] == pytest.approx([0.05] * 4)

    def test_heralded_erase_adds_herald_record(self):
        b = parse_stim_circuit(
            tsim_tpu_torch.Circuit("HERALDED_ERASE(0.2) 0\nM 0").cast_to_stim()
        )
        assert len(b.rec) == 2

    def test_heralded_erase_multiple_targets_independent(self):
        b = parse_stim_circuit(
            tsim_tpu_torch.Circuit("HERALDED_ERASE(0.2) 0 1\nM 0 1").cast_to_stim()
        )
        assert len(b.channel_probs) == 2
        assert len(b.rec) == 4

    def test_heralded_pauli_channel_1_distribution(self):
        b = parse_stim_circuit(
            tsim_tpu_torch.Circuit(
                "HERALDED_PAULI_CHANNEL_1(0.01,0.02,0.03,0.04) 0\nM 0"
            ).cast_to_stim()
        )
        [probs] = b.channel_probs
        assert probs[0] == pytest.approx(0.9)
        assert probs.sum() == pytest.approx(1.0)
        assert sorted(probs[1:], reverse=True)[:4] == pytest.approx(
            [0.04, 0.03, 0.02, 0.01]
        )


# ------------------------------------------------------ probability channels
class TestProbabilityChannels:
    @pytest.mark.parametrize(
        "text,outcomes",
        [
            ("X_ERROR(0.1) 0", 2),
            ("Y_ERROR(0.1) 0", 2),
            ("Z_ERROR(0.1) 0", 2),
            ("DEPOLARIZE1(0.1) 0", 4),
            ("DEPOLARIZE2(0.1) 0 1", 16),
            ("PAULI_CHANNEL_1(0.01,0.02,0.03) 0", 4),
        ],
    )
    def test_channel_outcome_counts(self, text, outcomes):
        b = parse_stim_circuit(tsim_tpu_torch.Circuit(text + "\nM 0 1").cast_to_stim())
        assert len(b.channel_probs) == 1
        assert len(b.channel_probs[0]) == outcomes

    def test_pauli_channel_2_outcomes(self):
        args = ",".join(["0.01"] * 15)
        b = parse_stim_circuit(
            tsim_tpu_torch.Circuit(f"PAULI_CHANNEL_2({args}) 0 1\nM 0 1").cast_to_stim()
        )
        assert len(b.channel_probs) == 1
        assert len(b.channel_probs[0]) == 16
        assert b.channel_probs[0][0] == pytest.approx(0.85)

    @pytest.mark.parametrize("gate", ["M", "MR", "MX", "MRX"])
    def test_noisy_measurement_single_flip_channel(self, gate):
        # The MR family must not double-count measurement noise: exactly one
        # flip channel per noisy measurement.
        b = parse_stim_circuit(tsim_tpu_torch.Circuit(f"{gate}(0.01) 0").cast_to_stim())
        assert len(b.channel_probs) == 1
        assert list(b.channel_probs[0]) == pytest.approx([0.99, 0.01])

    def test_repeated_error_instructions_are_independent(self):
        b = parse_stim_circuit(
            tsim_tpu_torch.Circuit("X_ERROR(0.1) 0\nX_ERROR(0.1) 0\nM 0").cast_to_stim()
        )
        assert len(b.channel_probs) == 2

    @pytest.mark.parametrize("text", ["II_ERROR(0.1) 0 1", "II_ERROR 0 1"])
    def test_identity_error_creates_no_channel(self, text):
        b = parse_stim_circuit(tsim_tpu_torch.Circuit(text + "\nM 0 1").cast_to_stim())
        assert len(b.channel_probs) == 0

    def test_ii_error_multiple_pairs_no_channels(self):
        b = parse_stim_circuit(
            tsim_tpu_torch.Circuit("II_ERROR(0.3) 0 1 2 3\nM 0 1 2 3").cast_to_stim()
        )
        assert len(b.channel_probs) == 0

    def test_error_bit_indices_allocated_in_program_order(self):
        b = parse_stim_circuit(
            tsim_tpu_torch.Circuit("X_ERROR(0.1) 0\nDEPOLARIZE1(0.2) 1\nM 0 1").cast_to_stim()
        )
        g = b.graph
        eparams = set()
        for v in g.vertices():
            eparams |= {p for p in g.get_params(v) if p.startswith("e")}
        # 1 bit for the flip channel + 2 bits for the 4-outcome depolarizer
        assert eparams == {"e0", "e1", "e2"}
        assert b.num_error_bits == 3


# ------------------------------------------------------------ repeat blocks
class TestRepeatAndStructure:
    def test_nested_repeat_blocks(self):
        b = parse_stim_circuit(
            tsim_tpu_torch.Circuit("REPEAT 2 {\nREPEAT 3 {\nM 0\n}\n}").cast_to_stim()
        )
        assert len(b.rec) == 6

    def test_repeat_block_with_noise_channels(self):
        b = parse_stim_circuit(
            tsim_tpu_torch.Circuit("REPEAT 3 {\nX_ERROR(0.1) 0\n}\nM 0").cast_to_stim()
        )
        assert len(b.channel_probs) == 3

    def test_empty_circuit(self):
        b = parse_stim_circuit(tsim_tpu_torch.Circuit("").cast_to_stim())
        assert b.rec == []
        assert b.channel_probs == []
        assert b.detectors == []

    def test_mixed_error_kinds_ordered(self):
        # Correlated-error chains finalize (and append their channel) when
        # the next non-ELSE instruction arrives, so the E channel lands after
        # the depolarizer despite appearing before it in the program.
        b = parse_stim_circuit(
            tsim_tpu_torch.Circuit(
                "X_ERROR(0.1) 0\nE(0.2) X0 Z1\nDEPOLARIZE1(0.3) 1\nM 0 1"
            ).cast_to_stim()
        )
        assert sorted(len(p) for p in b.channel_probs) == [2, 2, 4]


# ------------------------------------------------------------------- MPAD
class TestMpad:
    def test_single_zero_pad(self):
        b = parse_stim_circuit(tsim_tpu_torch.Circuit("MPAD 0").cast_to_stim())
        assert len(b.rec) == 1
        assert b.silent_rec == []

    def test_single_one_pad(self):
        b = parse_stim_circuit(tsim_tpu_torch.Circuit("MPAD 1").cast_to_stim())
        assert len(b.rec) == 1
        assert len(b.channel_probs) == 0

    def test_multiple_targets(self):
        b = parse_stim_circuit(tsim_tpu_torch.Circuit("MPAD 1 1 0").cast_to_stim())
        assert len(b.rec) == 3

    def test_mixed_with_measurements(self):
        b = parse_stim_circuit(
            tsim_tpu_torch.Circuit("M 0\nMPAD 1\nM 1\nDETECTOR rec[-2]").cast_to_stim()
        )
        assert len(b.rec) == 3

    def test_inside_repeat_block(self):
        b = parse_stim_circuit(
            tsim_tpu_torch.Circuit("REPEAT 2 {\nMPAD 1\n}").cast_to_stim()
        )
        assert len(b.rec) == 2

    def test_pad_value_is_deterministic(self):
        c = tsim_tpu_torch.Circuit("MPAD 1 0\nDETECTOR rec[-2]\nDETECTOR rec[-1]")
        out = _deterministic_detectors(c)
        assert out[:, 0].all() and not out[:, 1].any()


# ---------------------------------------------------------- MXX/MYY/MZZ
class TestPairMeasurements:
    @pytest.mark.parametrize("gate", ["MXX", "MYY", "MZZ"])
    def test_single_pair_one_record(self, gate):
        b = parse_stim_circuit(tsim_tpu_torch.Circuit(f"{gate} 0 1").cast_to_stim())
        assert len(b.rec) == 1
        assert len(b.channel_probs) == 0

    @pytest.mark.parametrize("gate", ["MXX", "MYY", "MZZ"])
    def test_multiple_pairs(self, gate):
        b = parse_stim_circuit(tsim_tpu_torch.Circuit(f"{gate} 0 1 2 3").cast_to_stim())
        assert len(b.rec) == 2

    @pytest.mark.parametrize("gate", ["MXX", "MYY", "MZZ"])
    def test_flip_probability_adds_channel_per_pair(self, gate):
        b = parse_stim_circuit(
            tsim_tpu_torch.Circuit(f"{gate}(0.01) 0 1 2 3").cast_to_stim()
        )
        assert len(b.channel_probs) == 2
        for p in b.channel_probs:
            assert list(p) == pytest.approx([0.99, 0.01])

    def test_mzz_deterministic_on_bell_pair(self):
        c = tsim_tpu_torch.Circuit("H 0\nCNOT 0 1\nMZZ 0 1\nDETECTOR rec[-1]")
        out = _deterministic_detectors(c)
        assert not out.any()

    def test_mxx_mixed_with_measurements(self):
        b = parse_stim_circuit(
            tsim_tpu_torch.Circuit("MXX 0 1\nM 2\nMZZ 3 4").cast_to_stim()
        )
        assert len(b.rec) == 3

    def test_mpp_with_flip_probability(self):
        b = parse_stim_circuit(
            tsim_tpu_torch.Circuit("MPP(0.02) X0*X1 Z2").cast_to_stim()
        )
        assert len(b.rec) == 2
        assert len(b.channel_probs) == 2
        for p in b.channel_probs:
            assert list(p) == pytest.approx([0.98, 0.02])


# ------------------------------------------------------------- SPP algebra
class TestSppUnitaries:
    def _mat(self, text):
        return tsim_tpu_torch.Circuit(text).to_matrix()

    def test_spp_single_pauli_phases_minus_eigenspace(self):
        import numpy as np

        m = self._mat("SPP Z0")
        assert m == pytest.approx(np.diag([1, 1j]))

    def test_spp_dag_single_pauli(self):
        import numpy as np

        m = self._mat("SPP_DAG Z0")
        assert m == pytest.approx(np.diag([1, -1j]))

    def test_spp_product_two_qubits(self):
        import numpy as np

        m = self._mat("SPP Z0*Z1")
        assert m == pytest.approx(np.diag([1, 1j, 1j, 1]))

    def test_spp_repeated_pauli_cancels_to_identity(self):
        # Full cancellation leaves an empty product: a scalar-1 circuit.
        m = self._mat("SPP X0*X0")
        assert m.shape == (1, 1)
        assert m[0, 0] == pytest.approx(1.0)

    def test_spp_partial_cancel(self):
        m1 = self._mat("SPP X0*X0*Z1")
        m2 = self._mat("SPP Z1")
        assert m1 == pytest.approx(m2)

    def test_spp_anticommuting_sign_flips_dagger(self):
        # X0 Y0 X1 Y1 = (iZ0)(iZ1) = -Z0 Z1: SPP(-P) == SPP_DAG(P).
        m1 = self._mat("SPP X0*Y0*X1*Y1")
        m2 = self._mat("SPP_DAG Z0*Z1")
        assert m1 == pytest.approx(m2)

    def test_spp_dag_anticommuting_sign_flips_to_plain(self):
        m1 = self._mat("SPP_DAG X0*Y0*X1*Y1")
        m2 = self._mat("SPP Z0*Z1")
        assert m1 == pytest.approx(m2)

    def test_spp_anti_hermitian_raises(self):
        with pytest.raises(ValueError, match="anti-Hermitian"):
            parse_stim_circuit(tsim_tpu_torch.Circuit("SPP X0*Y0").cast_to_stim())

    def test_spp_multiple_products_compose(self):
        # Two products in one instruction == the two instructions in sequence.
        m1 = self._mat("SPP X0 Z1")
        m2 = self._mat("SPP X0\nSPP Z1")
        assert m1 == pytest.approx(m2)

    def test_tpp_is_t_gate_on_z(self):
        import numpy as np

        m = self._mat("TPP Z0")
        w = np.exp(1j * np.pi / 4)
        assert m == pytest.approx(np.diag([1, w]))

    def test_tpp_dag_inverse(self):
        import numpy as np

        m = self._mat("TPP Z0") @ self._mat("TPP_DAG Z0")
        assert m == pytest.approx(np.eye(2))

    def test_tpp_product_eighth_turn(self):
        import numpy as np

        m = self._mat("TPP Z0*Z1")
        w = np.exp(1j * np.pi / 4)
        assert m == pytest.approx(np.diag([1, w, w, 1]))


# ------------------------------------------------------------ MPP algebra
class TestMppAlgebra:
    def test_full_cancel_reduces_to_deterministic_pad(self):
        # X0*X0 = +I: the measurement is deterministically 0.
        c = tsim_tpu_torch.Circuit("MPP X0*X0\nDETECTOR rec[-1]")
        out = _deterministic_detectors(c)
        assert not out.any()

    def test_full_cancel_inverted_reads_one(self):
        c = tsim_tpu_torch.Circuit("MPP !X0*X0\nDETECTOR rec[-1]")
        out = _deterministic_detectors(c)
        assert out.all()

    def test_anticommuting_sign_with_explicit_invert(self):
        # (X0 Y0)(X1 Y1) = -Z0 Z1; the explicit ! cancels the algebra sign.
        [(paulis, invert)] = _products("MPP !X0*Y0*X1*Y1")
        assert paulis == [("Z", 0), ("Z", 1)]
        assert not invert

    def test_combines_to_single_pauli_with_sign(self):
        # Z0 X0 Z0 = -X0... via pairs: X0*Y0*Y0*X0 cancels fully to +I.
        [(paulis, invert)] = _products("MPP X0*Y0*Y0*X0")
        assert paulis == []
        assert not invert

    def test_multiple_products_have_independent_state(self):
        prods = _products("MPP X0*Y0*X1*Y1 Z2")
        assert [inv for _, inv in prods] == [True, False]

    def test_anti_hermitian_multi_qubit_raises(self):
        # X0 Y0 Z1 = (iZ0) Z1: a net factor of i over two qubits.
        with pytest.raises(ValueError, match="anti-Hermitian"):
            _products("MPP X0*Y0*Z1")

    def test_mpp_y_basis_measurement(self):
        # MPP Y0 on |+i> is deterministic.
        c = tsim_tpu_torch.Circuit("H 0\nS 0\nMPP Y0\nDETECTOR rec[-1]")
        out = _deterministic_detectors(c)
        assert not out.any()


# ----------------------------------------------------- detectors/observables
class TestDetectorsAndObservables:
    def test_empty_detector_alone(self):
        b = parse_stim_circuit(tsim_tpu_torch.Circuit("DETECTOR").cast_to_stim())
        assert len(b.detectors) == 1

    def test_empty_observable_alone(self):
        b = parse_stim_circuit(
            tsim_tpu_torch.Circuit("OBSERVABLE_INCLUDE(0)").cast_to_stim()
        )
        assert list(b.observables_dict) == [0]

    def test_empty_detector_after_measurement(self):
        b = parse_stim_circuit(tsim_tpu_torch.Circuit("M 0\nDETECTOR").cast_to_stim())
        assert len(b.detectors) == 1

    def test_empty_detector_with_coordinate_args(self):
        b = parse_stim_circuit(
            tsim_tpu_torch.Circuit("M 0\nDETECTOR(1, 2, 3)").cast_to_stim()
        )
        assert len(b.detectors) == 1

    def test_detector_pauli_target_rejected(self):
        from tsim_tpu_torch import stim_core

        sc = StimCircuit("M 0")
        with pytest.raises(ValueError, match="[Pp]auli|target"):
            sc.append("DETECTOR", [stim_core.target_x(0)])

    def test_record_targets_accepted(self):
        b = parse_stim_circuit(
            tsim_tpu_torch.Circuit("M 0 1\nDETECTOR rec[-1] rec[-2]").cast_to_stim()
        )
        assert len(b.detectors) == 1

    def test_observables_sorted_after_out_of_order(self):
        b = parse_stim_circuit(
            tsim_tpu_torch.Circuit(
                "M 0\nOBSERVABLE_INCLUDE(3) rec[-1]\nOBSERVABLE_INCLUDE(1) rec[-1]"
            ).cast_to_stim()
        )
        assert list(b.observables_dict.keys()) == [0, 1, 2, 3]

    def test_no_observables_remains_empty(self):
        b = parse_stim_circuit(tsim_tpu_torch.Circuit("M 0\nDETECTOR rec[-1]").cast_to_stim())
        assert b.observables_dict == {}
