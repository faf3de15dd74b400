"""SparseTensor facade conformance tests (reference oracle:
``/root/reference/test/test_tensor.py``)."""
from itertools import product

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_sparse_jax import SparseTensor
from paddle_sparse_jax.testing import (devices, grad_dtypes,
                                       maybe_skip_testing, set_testing_device)

rng = np.random.default_rng(1234)


@pytest.mark.parametrize("dtype,device", product(grad_dtypes, devices))
def test_getitem(dtype, device):
    maybe_skip_testing(dtype, device)
    set_testing_device(device)

    m, n, k = 50, 40, 10
    mat = jnp.asarray(rng.standard_normal((m, n)), dtype=dtype)
    mat = SparseTensor.from_dense(mat)

    idx1 = jnp.asarray(rng.integers(0, m, (k,)), dtype=jnp.int64)
    idx2 = jnp.asarray(rng.integers(0, n, (k,)), dtype=jnp.int64)
    bool1 = jnp.zeros((m,), bool).at[idx1].set(True)
    bool2 = jnp.zeros((n,), bool).at[idx2].set(True)

    k1_bool = int(bool1.sum())
    k2_bool = int(bool2.sum())

    idx1np, idx2np = np.asarray(idx1), np.asarray(idx2)
    bool1np, bool2np = np.asarray(bool1), np.asarray(bool2)

    assert mat[:k, :k].sizes() == [k, k]
    assert mat[..., :k].sizes() == [m, k]

    assert mat[idx1, idx2].sizes() == [k, k]
    assert mat[idx1np, idx2np].sizes() == [k, k]
    assert mat[idx1np.tolist(), idx2np.tolist()].sizes() == [k, k]

    assert mat[bool1, bool2].sizes() == [k1_bool, k2_bool]
    assert mat[bool1np, bool2np].sizes() == [k1_bool, k2_bool]
    assert mat[bool1np.tolist(), bool2np.tolist()].sizes() == [k1_bool, k2_bool]

    assert mat[idx1].sizes() == [k, n]
    assert mat[bool1].sizes() == [k1_bool, n]

    # content check vs dense slicing
    dense = np.asarray(mat.to_dense())
    np.testing.assert_allclose(
        np.asarray(mat[:k, :k].to_dense()), dense[:k, :k], rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(mat[bool1].to_dense()), dense[np.asarray(bool1)],
        rtol=1e-6)


@pytest.mark.parametrize("device", devices)
def test_to_symmetric(device):
    set_testing_device(device)

    row = jnp.asarray([0, 0, 0, 1, 1])
    col = jnp.asarray([0, 1, 2, 0, 2])
    value = jnp.arange(1, 6)
    mat = SparseTensor(row=row, col=col, value=value)
    assert not mat.is_symmetric()

    mat = mat.to_symmetric()
    assert mat.is_symmetric()
    assert mat.to_dense().tolist() == [[2, 6, 3], [6, 0, 5], [3, 5, 0]]


def test_equal():
    row = jnp.asarray([0, 0, 0, 1, 1])
    col = jnp.asarray([0, 1, 2, 0, 2])
    value = jnp.arange(1, 6)
    matA = SparseTensor(row=row, col=col, value=value)
    matB = SparseTensor(row=row, col=col, value=value)
    matC = SparseTensor(row=row, col=jnp.asarray([0, 1, 2, 0, 1]),
                        value=value)

    assert id(matA) != id(matB) and matA == matB
    assert id(matA) != id(matC) and matA != matC


def test_to():
    row = jnp.asarray([0, 0, 0, 1, 1])
    col = jnp.asarray([0, 1, 2, 0, 2])
    value = jnp.arange(1, 6)
    mat = SparseTensor(row=row, col=col, value=value)

    assert mat.storage.value().dtype in (jnp.int64, jnp.int32)

    mat = mat.to(jnp.float32)
    assert mat.storage.value().dtype == jnp.float32

    cpu0 = jax.devices("cpu")[0]
    mat = mat.to(cpu0, jnp.float32)
    assert next(iter(mat.storage.value().devices())) == cpu0
    assert next(iter(mat.storage.row().devices())) == cpu0
    assert next(iter(mat.storage.col().devices())) == cpu0


def test_from_dense_multi_dim():
    mat = jnp.zeros((3, 4, 2))
    mat = mat.at[0, 1].set(jnp.asarray([1.0, 2.0]))
    mat = mat.at[2, 3].set(jnp.asarray([3.0, 4.0]))
    sp = SparseTensor.from_dense(mat)
    assert sp.sizes() == [3, 4, 2]
    assert sp.nnz() == 2
    np.testing.assert_array_equal(np.asarray(sp.to_dense()), np.asarray(mat))


def test_stats_and_repr():
    mat = SparseTensor.eye(4, 6)
    assert mat.is_quadratic() is False
    assert mat.density() == 4 / 24
    assert 0 < mat.avg_row_length() <= 4
    assert mat.bandwidth() == 0
    assert "SparseTensor" in repr(mat)


def test_pytree_roundtrip():
    mat = SparseTensor.eye(5).to_padded(capacity=8)
    leaves, treedef = jax.tree_util.tree_flatten(mat)
    mat2 = jax.tree_util.tree_unflatten(treedef, leaves)
    back = mat2.to_eager()
    assert back == SparseTensor.eye(5)
