"""Channel algebra tests (bit layouts, simplification, sampling)."""

import numpy as np
import pytest

from tsim_tpu_torch.noise.channels import (
    Channel,
    ChannelSampler,
    absorb_subset_channels,
    correlated_error_probs,
    error_probs,
    expand_channel,
    fold_duplicate_channel_bits,
    heralded_pauli_channel_1_probs,
    merge_identical_channels,
    normalize_channels,
    pauli_channel_1_probs,
    pauli_channel_2_probs,
    reduce_null_bits,
    simplify_channels,
    xor_convolve,
)


def test_prob_constructors():
    np.testing.assert_allclose(error_probs(0.25), [0.75, 0.25])
    p1 = pauli_channel_1_probs(0.1, 0.2, 0.3)
    np.testing.assert_allclose(p1, [0.4, 0.3, 0.1, 0.2])  # I, Z, X, Y
    h = heralded_pauli_channel_1_probs(0.1, 0.05, 0.02, 0.03)
    np.testing.assert_allclose(h[0], 1 - 0.2)
    assert h[1] == 0.1 and h[5] == 0.05 and h[7] == 0.02 and h[3] == 0.03
    p2 = pauli_channel_2_probs(*range(1, 16))
    # index z_i + 2 x_i + 4 z_j + 8 x_j; pzx: Z on i, X on j -> 1 + 8 = 9
    assert p2[9] == 13  # pzx is the 13th argument
    c = correlated_error_probs([0.5, 0.5])
    np.testing.assert_allclose(c, [0.25, 0.5, 0.25, 0.0])


def test_xor_convolve():
    a = np.array([0.9, 0.1])
    b = np.array([0.8, 0.2])
    out = xor_convolve(a, b)
    np.testing.assert_allclose(out, [0.9 * 0.8 + 0.1 * 0.2, 0.9 * 0.2 + 0.1 * 0.8])


def test_reduce_null_bits():
    ch = Channel(probs=pauli_channel_1_probs(0.1, 0.0, 0.2), unique_col_ids=(0, 1))
    (out,) = reduce_null_bits([ch], null_col_id=0)
    # bit 0 (Z) marginalized out: remaining bit is X component
    assert out.unique_col_ids == (1,)
    np.testing.assert_allclose(out.probs, [0.9, 0.1])
    # channel entirely null is removed
    ch2 = Channel(probs=error_probs(0.3), unique_col_ids=(0,))
    assert reduce_null_bits([ch2], null_col_id=0) == []


def test_normalize_and_fold():
    ch = Channel(probs=pauli_channel_1_probs(0.1, 0.0, 0.2), unique_col_ids=(2, 1))
    (out,) = normalize_channels([ch])
    assert out.unique_col_ids == (1, 2)
    # swapped axes: bit0 now col1 (was X), bit1 col2 (was Z)
    np.testing.assert_allclose(out.probs, [0.7, 0.1, 0.2, 0.0])

    dup = Channel(probs=pauli_channel_1_probs(0.1, 0.0, 0.2), unique_col_ids=(1, 1))
    (folded,) = fold_duplicate_channel_bits([dup])
    assert folded.unique_col_ids == (1,)
    np.testing.assert_allclose(folded.probs, [0.7 + 0.0, 0.2 + 0.1])


def test_merge_and_absorb():
    a = Channel(probs=error_probs(0.1), unique_col_ids=(1,))
    b = Channel(probs=error_probs(0.2), unique_col_ids=(1,))
    (merged,) = merge_identical_channels([a, b])
    np.testing.assert_allclose(merged.probs, xor_convolve(a.probs, b.probs))

    big = Channel(probs=pauli_channel_1_probs(0.1, 0.05, 0.2), unique_col_ids=(1, 2))
    small = Channel(probs=error_probs(0.3), unique_col_ids=(1,))
    out = absorb_subset_channels([big, small])
    assert len(out) == 1
    expanded = expand_channel(small, (1, 2))
    np.testing.assert_allclose(out[0].probs, xor_convolve(big.probs, expanded.probs))


def test_channel_sampler_statistics():
    transform = np.array([[1, 1, 0], [0, 1, 1]], dtype=np.uint8)
    probs = [error_probs(0.3), error_probs(0.25), error_probs(0.4)]
    cs = ChannelSampler(probs, transform, seed=7)
    out = cs.sample(200000)
    # f0 = e0 ^ e1, f1 = e1 ^ e2
    p_e = [0.3, 0.25, 0.4]
    exp_f0 = p_e[0] * (1 - p_e[1]) + p_e[1] * (1 - p_e[0])
    exp_f1 = p_e[1] * (1 - p_e[2]) + p_e[2] * (1 - p_e[1])
    np.testing.assert_allclose(out.mean(axis=0), [exp_f0, exp_f1], atol=0.006)


def test_channel_sampler_correlations():
    # A two-bit channel hitting distinct columns keeps correlations.
    transform = np.eye(2, dtype=np.uint8)
    probs = [pauli_channel_1_probs(0.0, 0.3, 0.0)]  # only Y: both bits together
    cs = ChannelSampler(probs, transform, seed=3)
    out = cs.sample(100000)
    assert abs(out[:, 0].mean() - 0.3) < 0.01
    np.testing.assert_array_equal(out[:, 0], out[:, 1])


def test_channel_validation():
    with pytest.raises(ValueError, match="sum to 1"):
        Channel(probs=np.array([0.5, 0.4]), unique_col_ids=(0,))
    with pytest.raises(ValueError, match="lie in"):
        Channel(probs=np.array([1.5, -0.5]), unique_col_ids=(0,))


# --------------------------------------------------------------------------
# Expanded algebra battery (reference test/unit/noise/test_channels.py is
# the semantic spec; all assertions re-derived against our Channel model).
# --------------------------------------------------------------------------

def _joint_dist(channels):
    """Exact distribution of the XOR-combined column assignment.

    Returns {colid_bitmask: prob}: bit c of the mask is the parity of all
    channel bits whose unique_col_id == c. Invariant under every
    simplification pass, which is exactly what these tests check.
    """
    dist = {0: 1.0}
    for ch in channels:
        new = {}
        for outcome, p in enumerate(ch.probs):
            if p == 0.0:
                continue
            mask = 0
            for pos, col in enumerate(ch.unique_col_ids):
                if (outcome >> pos) & 1:
                    mask ^= 1 << col
            for m0, p0 in dist.items():
                key = m0 ^ mask
                new[key] = new.get(key, 0.0) + p0 * p
        dist = new
    return dist


def _assert_same_dist(a, b, tol=1e-12):
    da, db = _joint_dist(a), _joint_dist(b)
    keys = set(da) | set(db)
    for k in keys:
        assert abs(da.get(k, 0.0) - db.get(k, 0.0)) < tol, (k, da, db)


class TestConstructors:
    def test_error_probs(self):
        assert list(error_probs(0.25)) == pytest.approx([0.75, 0.25])

    def test_pauli_channel_1_bit_order(self):
        # little-endian (z, x): outcome 1 = Z, 2 = X, 3 = Y.
        p = pauli_channel_1_probs(0.01, 0.02, 0.03)
        assert list(p) == pytest.approx([0.94, 0.03, 0.01, 0.02])

    def test_pauli_channel_2_mass_and_identity(self):
        ps = [0.01] * 15
        p = pauli_channel_2_probs(*ps)
        assert p[0] == pytest.approx(0.85)
        assert p.sum() == pytest.approx(1.0)

    def test_pauli_channel_2_single_term_position(self):
        # pzz is the last argument: both z bits set -> outcome 0b0101 = 5.
        ps = [0.0] * 15
        ps[14] = 0.125  # pzz
        p = pauli_channel_2_probs(*ps)
        assert p[5] == pytest.approx(0.125)

    def test_heralded_pauli_channel_1(self):
        p = heralded_pauli_channel_1_probs(0.01, 0.02, 0.03, 0.04)
        assert p[0] == pytest.approx(0.9)
        assert p[1] == pytest.approx(0.01)  # herald only
        assert p[3] == pytest.approx(0.04)  # herald + Z
        assert p[5] == pytest.approx(0.02)  # herald + X
        assert p[7] == pytest.approx(0.03)  # herald + Y

    def test_heralded_pauli_channel_1_pure_z(self):
        p = heralded_pauli_channel_1_probs(0.0, 0.0, 0.0, 0.1)
        assert p[3] == pytest.approx(0.1)
        assert p[0] == pytest.approx(0.9)
        assert p[[1, 2, 4, 5, 6, 7]].sum() == 0.0


class TestCorrelatedErrorProbs:
    def test_single_error(self):
        assert list(correlated_error_probs([0.1])) == pytest.approx([0.9, 0.1])

    def test_two_errors_exclusive(self):
        p = correlated_error_probs([0.5, 0.5])
        # P(first)=0.5, P(second | not first)=0.5 -> 0.25, P(none)=0.25.
        assert list(p) == pytest.approx([0.25, 0.5, 0.25, 0.0])

    def test_three_errors_uniform(self):
        p = correlated_error_probs([0.25, 1 / 3, 0.5])
        assert p[1] == pytest.approx(0.25)
        assert p[2] == pytest.approx(0.25)
        assert p[4] == pytest.approx(0.25)
        assert p[0] == pytest.approx(0.25)

    def test_zero_probability_alternative(self):
        p = correlated_error_probs([0.3, 0.0])
        assert p[2] == 0.0
        assert p.sum() == pytest.approx(1.0)

    def test_certain_first_error(self):
        p = correlated_error_probs([1.0, 0.7])
        assert p[1] == pytest.approx(1.0)
        assert p[0] == pytest.approx(0.0)
        assert p[2] == pytest.approx(0.0)


class TestValidation:
    def test_rejects_negative_entry(self):
        with pytest.raises(ValueError, match="lie in"):
            Channel(probs=np.array([1.2, -0.2]), unique_col_ids=(0,))

    def test_rejects_entry_above_one(self):
        with pytest.raises(ValueError, match="lie in"):
            Channel(probs=np.array([1.4, -0.4]), unique_col_ids=(0,))

    def test_rejects_sum_below_one(self):
        with pytest.raises(ValueError, match="sum to 1"):
            Channel(probs=np.array([0.5, 0.4]), unique_col_ids=(0,))

    def test_rejects_sum_above_one(self):
        with pytest.raises(ValueError, match="sum to 1"):
            Channel(probs=np.array([0.8, 0.4]), unique_col_ids=(0,))


class TestXorConvolve:
    def test_two_bernoulli(self):
        out = xor_convolve(error_probs(0.1), error_probs(0.2))
        # P(xor=1) = 0.1*0.8 + 0.9*0.2 = 0.26
        assert list(out) == pytest.approx([0.74, 0.26])

    def test_identity_convolve(self):
        p = np.array([0.7, 0.1, 0.1, 0.1])
        out = xor_convolve(p, np.array([1.0, 0, 0, 0]))
        assert list(out) == pytest.approx(list(p))

    def test_two_2bit_channels(self):
        a = np.array([0.7, 0.1, 0.1, 0.1])
        out = xor_convolve(a, a)
        # P(0) = 0.49 + 3*0.01 = 0.52; each nonzero = 2*0.07 + 2*0.01 = 0.16
        assert list(out) == pytest.approx([0.52, 0.16, 0.16, 0.16])

    def test_length_mismatch_raises(self):
        with pytest.raises(ValueError, match="same number"):
            xor_convolve(error_probs(0.1), np.array([0.5, 0.25, 0.25, 0.0]))


class TestMergeIdentical:
    def test_merge_two_1bit_same_signature(self):
        chans = [
            Channel(error_probs(0.1), (3,)),
            Channel(error_probs(0.2), (3,)),
        ]
        out = merge_identical_channels(chans)
        assert len(out) == 1
        assert list(out[0].probs) == pytest.approx([0.74, 0.26])

    def test_merge_two_2bit_same_signature(self):
        a = Channel(np.array([0.7, 0.1, 0.1, 0.1]), (1, 4))
        out = merge_identical_channels([a, a])
        assert len(out) == 1
        _assert_same_dist([a, a], out)

    def test_no_merge_different_signatures(self):
        chans = [
            Channel(error_probs(0.1), (0,)),
            Channel(error_probs(0.2), (1,)),
        ]
        assert len(merge_identical_channels(chans)) == 2

    def test_distribution_preserved(self):
        chans = [
            Channel(pauli_channel_1_probs(0.01, 0.02, 0.03), (2, 5)),
            Channel(pauli_channel_1_probs(0.05, 0.01, 0.02), (2, 5)),
            Channel(error_probs(0.3), (7,)),
        ]
        _assert_same_dist(chans, merge_identical_channels(chans))


class TestExpandChannel:
    def test_expand_1bit_to_2bit_low(self):
        ch = Channel(error_probs(0.2), (0,))
        out = expand_channel(ch, (0, 1))
        assert list(out.probs) == pytest.approx([0.8, 0.2, 0.0, 0.0])

    def test_expand_1bit_to_2bit_high(self):
        ch = Channel(error_probs(0.2), (1,))
        out = expand_channel(ch, (0, 1))
        assert list(out.probs) == pytest.approx([0.8, 0.0, 0.2, 0.0])

    @pytest.mark.parametrize("col", [0, 1, 2])
    def test_expand_1bit_to_3bit(self, col):
        ch = Channel(error_probs(0.25), (col,))
        out = expand_channel(ch, (0, 1, 2))
        assert out.probs[0] == pytest.approx(0.75)
        assert out.probs[1 << col] == pytest.approx(0.25)
        _assert_same_dist([ch], [out])

    @pytest.mark.parametrize("col", [0, 2, 4])
    def test_expand_1bit_to_5bit(self, col):
        ch = Channel(error_probs(0.125), (col,))
        out = expand_channel(ch, (0, 1, 2, 3, 4))
        assert out.probs[1 << col] == pytest.approx(0.125)
        _assert_same_dist([ch], [out])

    @pytest.mark.parametrize("src", [(0, 2), (1, 3), (0, 3)])
    def test_expand_2bit_to_4bit_preserves_positions(self, src):
        ch = Channel(np.array([0.7, 0.1, 0.1, 0.1]), src)
        out = expand_channel(ch, (0, 1, 2, 3))
        _assert_same_dist([ch], [out])

    def test_expand_rejects_duplicate_target(self):
        ch = Channel(error_probs(0.1), (0,))
        with pytest.raises(ValueError, match="duplicates"):
            expand_channel(ch, (0, 1, 1))

    def test_expand_rejects_unsorted_source(self):
        ch = Channel(np.array([0.7, 0.1, 0.1, 0.1]), (2, 0))
        with pytest.raises(ValueError, match="sorted"):
            expand_channel(ch, (0, 1, 2))

    def test_expand_rejects_unsorted_target(self):
        ch = Channel(error_probs(0.1), (0,))
        with pytest.raises(ValueError, match="sorted"):
            expand_channel(ch, (1, 0))

    @pytest.mark.parametrize("target", [(0,), (1, 2), (0, 1, 1)])
    def test_expand_rejects_non_strict_superset(self, target):
        ch = Channel(error_probs(0.1), (0,))
        with pytest.raises(ValueError):
            expand_channel(ch, target)


class TestFoldDuplicateBits:
    def test_two_duplicate_bits_xor(self):
        # (b0, b1) both mapped to column 5: outcomes fold by parity.
        ch = Channel(np.array([0.4, 0.3, 0.2, 0.1]), (5, 5))
        [out] = fold_duplicate_channel_bits([ch])
        assert out.unique_col_ids == (5,)
        assert list(out.probs) == pytest.approx([0.5, 0.5])

    def test_three_duplicate_bits_parity(self):
        probs = np.full(8, 1 / 8)
        ch = Channel(probs, (2, 2, 2))
        [out] = fold_duplicate_channel_bits([ch])
        assert out.unique_col_ids == (2,)
        assert list(out.probs) == pytest.approx([0.5, 0.5])

    def test_partial_duplicates(self):
        probs = np.full(8, 1 / 8)
        ch = Channel(probs, (1, 4, 1))
        [out] = fold_duplicate_channel_bits([ch])
        assert out.unique_col_ids == (1, 4)
        assert out.probs.sum() == pytest.approx(1.0)
        _assert_same_dist([ch], [out])

    def test_preserves_probability_mass(self):
        ch = Channel(pauli_channel_1_probs(0.1, 0.2, 0.3), (6, 6))
        [out] = fold_duplicate_channel_bits([ch])
        assert out.probs.sum() == pytest.approx(1.0)

    def test_multiple_channels_mixed(self):
        chans = [
            Channel(np.array([0.4, 0.3, 0.2, 0.1]), (0, 0)),
            Channel(error_probs(0.2), (1,)),
        ]
        out = fold_duplicate_channel_bits(chans)
        assert [c.unique_col_ids for c in out] == [(0,), (1,)]
        _assert_same_dist(chans, out)

    def test_no_duplicates_pass_through(self):
        ch = Channel(np.array([0.4, 0.3, 0.2, 0.1]), (0, 1))
        [out] = fold_duplicate_channel_bits([ch])
        assert out is ch

    def test_empty_list(self):
        assert fold_duplicate_channel_bits([]) == []


class TestNormalizeChannels:
    def test_already_sorted_unchanged(self):
        ch = Channel(np.array([0.4, 0.3, 0.2, 0.1]), (0, 1))
        [out] = normalize_channels([ch])
        assert out.unique_col_ids == (0, 1)
        assert list(out.probs) == pytest.approx(list(ch.probs))

    def test_2bit_reorder(self):
        ch = Channel(np.array([0.4, 0.3, 0.2, 0.1]), (7, 2))
        [out] = normalize_channels([ch])
        assert out.unique_col_ids == (2, 7)
        # bit swap: outcome (b7, b2) -> (b2, b7)
        assert list(out.probs) == pytest.approx([0.4, 0.2, 0.3, 0.1])
        _assert_same_dist([ch], [out])

    def test_3bit_reorder(self):
        probs = np.arange(8, dtype=np.float64)
        probs /= probs.sum()
        ch = Channel(probs, (5, 0, 3))
        [out] = normalize_channels([ch])
        assert out.unique_col_ids == (0, 3, 5)
        _assert_same_dist([ch], [out])


class TestAbsorbSubset:
    def test_absorb_1bit_into_2bit(self):
        big = Channel(np.array([0.7, 0.1, 0.1, 0.1]), (0, 1))
        small = Channel(error_probs(0.2), (0,))
        out = absorb_subset_channels([big, small])
        assert len(out) == 1
        _assert_same_dist([big, small], out)

    def test_no_absorb_disjoint(self):
        a = Channel(np.array([0.7, 0.1, 0.1, 0.1]), (0, 1))
        b = Channel(error_probs(0.2), (2,))
        assert len(absorb_subset_channels([a, b])) == 2

    def test_no_absorb_partial_overlap(self):
        a = Channel(np.array([0.7, 0.1, 0.1, 0.1]), (0, 1))
        b = Channel(np.array([0.7, 0.1, 0.1, 0.1]), (1, 2))
        assert len(absorb_subset_channels([a, b])) == 2

    def test_absorb_chain_into_largest(self):
        big = Channel(np.full(8, 1 / 8), (0, 1, 2))
        mid = Channel(np.array([0.7, 0.1, 0.1, 0.1]), (0, 2))
        small = Channel(error_probs(0.1), (1,))
        out = absorb_subset_channels([small, mid, big])
        assert len(out) == 1
        _assert_same_dist([big, mid, small], out)

    def test_respects_max_bits(self):
        big = Channel(np.full(32, 1 / 32), (0, 1, 2, 3, 4))
        small = Channel(error_probs(0.1), (2,))
        out = absorb_subset_channels([big, small], max_bits=4)
        assert len(out) == 2


class TestReduceNullBits:
    def test_1bit_all_null_removed(self):
        ch = Channel(error_probs(0.3), (9,))
        assert reduce_null_bits([ch], null_col_id=9) == []

    def test_no_null_unchanged(self):
        ch = Channel(error_probs(0.3), (1,))
        [out] = reduce_null_bits([ch], null_col_id=9)
        assert out is ch

    def test_none_null_id_passthrough(self):
        ch = Channel(error_probs(0.3), (9,))
        assert reduce_null_bits([ch]) == [ch]

    @pytest.mark.parametrize("null_pos", [0, 1])
    def test_2bit_one_null_marginalizes(self, null_pos):
        cols = [3, 3]
        cols[1 - null_pos] = 1
        ch = Channel(np.array([0.4, 0.3, 0.2, 0.1]), tuple(cols))
        [out] = reduce_null_bits([ch], null_col_id=3)
        assert out.unique_col_ids == (1,)
        assert out.probs.sum() == pytest.approx(1.0)
        if null_pos == 0:
            assert list(out.probs) == pytest.approx([0.7, 0.3])
        else:
            assert list(out.probs) == pytest.approx([0.6, 0.4])

    def test_3bit_two_null_marginalize(self):
        probs = np.arange(1, 9, dtype=np.float64)
        probs /= probs.sum()
        ch = Channel(probs, (4, 0, 4))
        [out] = reduce_null_bits([ch], null_col_id=4)
        assert out.unique_col_ids == (0,)
        assert out.probs.sum() == pytest.approx(1.0)

    def test_sum_to_one_after_marginalization(self):
        ch = Channel(np.full(16, 1 / 16), (0, 5, 1, 5))
        [out] = reduce_null_bits([ch], null_col_id=5)
        assert out.probs.sum() == pytest.approx(1.0)
        assert out.unique_col_ids == (0, 1)


class TestSimplifyPipeline:
    def test_mixed_channels(self):
        chans = [
            Channel(error_probs(0.1), (2,)),
            Channel(error_probs(0.2), (2,)),
            Channel(np.array([0.7, 0.1, 0.1, 0.1]), (3, 2)),
            Channel(error_probs(0.05), (9,)),
        ]
        out = simplify_channels(chans)
        _assert_same_dist(chans, out)
        assert len(out) == 2  # (2,3) absorbs everything on {2,3}; (9,) apart

    def test_many_1bit_channels_merge(self):
        chans = [Channel(error_probs(0.1), (1,)) for _ in range(5)]
        out = simplify_channels(chans)
        assert len(out) == 1
        _assert_same_dist(chans, out)

    def test_preserves_independent_channels(self):
        chans = [
            Channel(error_probs(0.1), (0,)),
            Channel(error_probs(0.2), (1,)),
            Channel(error_probs(0.3), (2,)),
        ]
        out = simplify_channels(chans)
        assert len(out) == 3
        _assert_same_dist(chans, out)

    def test_folds_duplicates_before_absorption(self):
        chans = [
            Channel(np.array([0.4, 0.3, 0.2, 0.1]), (2, 2)),
            Channel(np.array([0.7, 0.1, 0.1, 0.1]), (1, 2)),
        ]
        out = simplify_channels(chans)
        assert len(out) == 1
        _assert_same_dist(chans, out)

    def test_unsorted_signatures_still_merge(self):
        chans = [
            Channel(np.array([0.7, 0.1, 0.1, 0.1]), (4, 1)),
            Channel(np.array([0.6, 0.2, 0.1, 0.1]), (1, 4)),
        ]
        out = simplify_channels(chans)
        assert len(out) == 1
        _assert_same_dist(chans, out)
