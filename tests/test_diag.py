"""Diag-family coverage (absent from the reference; upstream semantics)."""
import jax.numpy as jnp
import numpy as np

from paddle_sparse_jax import SparseTensor


def _mat():
    dense = jnp.asarray([[1.0, 2, 0], [0, 3, 4], [5, 0, 6]])
    return SparseTensor.from_dense(dense), np.asarray(dense)


def test_remove_diag():
    mat, dense = _mat()
    out = mat.remove_diag()
    expected = dense.copy()
    np.fill_diagonal(expected, 0)
    np.testing.assert_array_equal(np.asarray(out.to_dense()), expected)


def test_remove_diag_offset():
    mat, dense = _mat()
    out = mat.remove_diag(k=1)
    expected = dense.copy()
    expected[0, 1] = 0
    expected[1, 2] = 0
    np.testing.assert_array_equal(np.asarray(out.to_dense()), expected)


def test_set_diag():
    mat, dense = _mat()
    out = mat.set_diag(jnp.asarray([9.0, 9, 9]))
    expected = dense.copy()
    np.fill_diagonal(expected, 9)
    np.testing.assert_array_equal(np.asarray(out.to_dense()), expected)


def test_fill_diag_offset():
    mat, dense = _mat()
    out = mat.fill_diag(7.0, k=-1)
    expected = dense.copy()
    expected[1, 0] = 7
    expected[2, 1] = 7
    np.testing.assert_array_equal(np.asarray(out.to_dense()), expected)


def test_get_diag():
    mat, dense = _mat()
    np.testing.assert_array_equal(np.asarray(mat.get_diag()),
                                  np.diag(dense))


def test_set_diag_rectangular():
    dense = jnp.asarray([[0.0, 1], [0, 0], [2, 0]])
    mat = SparseTensor.from_dense(dense)
    out = mat.set_diag(jnp.asarray([5.0, 5]))
    expected = np.asarray(dense).copy()
    expected[0, 0] = 5
    expected[1, 1] = 5
    np.testing.assert_array_equal(np.asarray(out.to_dense()), expected)
