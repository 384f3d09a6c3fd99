"""GF(2) linear algebra of the port (``tsim_tpu_torch/ops/gf2.py``):
find_basis properties and parity matmul, mirrored from
``tests/unit/test_gf2.py``; the device functions take torch tensors.

Covers the reference's linalg matrix (reference ``test/unit/utils/
test_linalg.py``), including the >255-set-bits case that would corrupt
parities if the mod-2 ran after a saturating uint8 cast.
"""

import numpy as np
import pytest
import torch

from tsim_tpu_torch.ops.gf2 import find_basis, static_take_columns
from tsim_tpu_torch.ops.gf2 import matmul_gf2 as _matmul_gf2


def matmul_gf2(a, b):
    return _matmul_gf2(torch.from_numpy(a), torch.from_numpy(b)).numpy()


class TestFindBasis:
    @pytest.mark.parametrize("seed", range(6))
    def test_reconstruction(self, seed):
        rng = np.random.default_rng(seed)
        v = rng.integers(0, 2, size=(12, 20)).astype(np.uint8)
        basis, transform = find_basis(v)
        np.testing.assert_array_equal((transform @ basis) % 2, v)

    def test_basis_rows_are_input_rows(self):
        v = np.array([[1, 0, 1], [0, 1, 1], [1, 1, 0]], np.uint8)
        basis, transform = find_basis(v)
        for row in basis:
            assert any(np.array_equal(row, r) for r in v)

    def test_rank_deficient(self):
        v = np.array([[1, 0], [1, 0], [0, 0], [1, 0]], np.uint8)
        basis, transform = find_basis(v)
        assert basis.shape == (1, 2)
        np.testing.assert_array_equal(transform, [[1], [1], [0], [1]])

    def test_first_seen_order(self):
        v = np.array([[0, 1], [1, 0], [1, 1]], np.uint8)
        basis, _ = find_basis(v)
        np.testing.assert_array_equal(basis, [[0, 1], [1, 0]])

    def test_empty(self):
        basis, transform = find_basis(np.zeros((0, 5), np.uint8))
        assert basis.shape[0] == 0
        assert transform.shape == (0, 0)

    def test_wide_rows_bitpacking(self):
        rng = np.random.default_rng(7)
        v = rng.integers(0, 2, size=(8, 300)).astype(np.uint8)
        basis, transform = find_basis(v)
        np.testing.assert_array_equal((transform @ basis) % 2, v)


class TestMatmulGf2:
    @pytest.mark.parametrize("seed", range(4))
    def test_matches_numpy(self, seed):
        rng = np.random.default_rng(seed)
        a = rng.integers(0, 2, size=(3, 5, 17)).astype(np.uint8)
        b = rng.integers(0, 2, size=(9, 17)).astype(np.uint8)
        got = np.asarray(matmul_gf2(a, b))
        want = np.einsum("tgp,bp->btg", a.astype(int), b.astype(int)) % 2
        np.testing.assert_array_equal(got, want)

    def test_over_255_set_bits(self):
        # Inner products above 255 must not saturate before the mod.
        p = 513
        a = np.ones((1, 1, p), np.uint8)
        b = np.ones((2, p), np.uint8)
        b[1, 0] = 0
        got = np.asarray(matmul_gf2(a, b))
        np.testing.assert_array_equal(got[:, 0, 0], [p % 2, (p - 1) % 2])

    def test_empty_graph_axis(self):
        a = np.zeros((0, 0, 4), np.uint8)
        b = np.zeros((3, 4), np.uint8)
        assert np.asarray(matmul_gf2(a, b)).shape == (3, 0, 0)


def test_static_take_columns():
    x = np.arange(12, dtype=np.uint8).reshape(3, 4)
    t = torch.from_numpy(x)
    got = static_take_columns(t, torch.tensor([2, 0, 2])).numpy()
    np.testing.assert_array_equal(got, x[:, [2, 0, 2]])
    assert static_take_columns(t, torch.tensor([], dtype=torch.long)).shape == (3, 0)
