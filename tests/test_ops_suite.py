"""Op-suite conformance tests: add / mul / cat / coalesce / transpose / eye /
permute / reduce / overloads (reference oracles: the same-named files in
``/root/reference/test/``)."""
from itertools import product

import jax.numpy as jnp
import numpy as np
import pytest

from paddle_sparse_jax import (SparseTensor, cat, coalesce, eye, transpose)
from paddle_sparse_jax.testing import (devices, dtypes, maybe_skip_testing,
                                       set_testing_device, tensor)


# ---------------------------------------------------------------------------
# add (test_add.py oracle)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,device", product(dtypes, devices))
def test_add(dtype, device):
    maybe_skip_testing(dtype, device)
    set_testing_device(device)

    rowA = jnp.asarray([0, 0, 1, 2, 2])
    colA = jnp.asarray([0, 2, 1, 0, 1])
    valueA = tensor([1, 2, 4, 1, 3], dtype, device)
    A = SparseTensor(row=rowA, col=colA, value=valueA)

    rowB = jnp.asarray([0, 0, 1, 2, 2])
    colB = jnp.asarray([1, 2, 2, 1, 2])
    valueB = tensor([2, 3, 1, 2, 4], dtype, device)
    B = SparseTensor(row=rowB, col=colB, value=valueB)

    C = A + B
    rowC, colC, valueC = C.coo()
    assert rowC.tolist() == [0, 0, 0, 1, 1, 2, 2, 2]
    assert colC.tolist() == [0, 1, 2, 1, 2, 0, 1, 2]
    np.testing.assert_array_equal(
        np.asarray(valueC),
        np.asarray(tensor([1, 2, 5, 4, 1, 1, 5, 4], dtype, device)))


# ---------------------------------------------------------------------------
# mul (test_mul.py oracle)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,device", product(dtypes, devices))
def test_sparse_sparse_mul(dtype, device):
    maybe_skip_testing(dtype, device)
    set_testing_device(device)

    A = SparseTensor(row=jnp.asarray([0, 0, 1, 2, 2]),
                     col=jnp.asarray([0, 2, 1, 0, 1]),
                     value=tensor([1, 2, 4, 1, 3], dtype, device))
    B = SparseTensor(row=jnp.asarray([0, 0, 1, 2, 2]),
                     col=jnp.asarray([1, 2, 2, 1, 2]),
                     value=tensor([2, 3, 1, 2, 4], dtype, device))

    C = A * B
    rowC, colC, valueC = C.coo()
    assert rowC.tolist() == [0, 2]
    assert colC.tolist() == [2, 1]
    np.testing.assert_array_equal(np.asarray(valueC),
                                  np.asarray(tensor([6, 6], dtype, device)))


@pytest.mark.parametrize("dtype,device", product(dtypes, devices))
def test_sparse_sparse_mul_empty(dtype, device):
    maybe_skip_testing(dtype, device)
    set_testing_device(device)

    A = SparseTensor(row=jnp.asarray([0]), col=jnp.asarray([1]),
                     value=tensor([1], dtype, device))
    B = SparseTensor(row=jnp.asarray([1]), col=jnp.asarray([0]),
                     value=tensor([2], dtype, device))
    C = A * B
    rowC, colC, valueC = C.coo()
    assert rowC.tolist() == []
    assert colC.tolist() == []
    assert valueC.tolist() == []


# ---------------------------------------------------------------------------
# cat (test_cat.py oracle, incl. cache-survival contract)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("device", devices)
def test_cat(device):
    set_testing_device(device)

    row, col = tensor([[0, 0, 1], [0, 1, 2]], jnp.int64, device)
    mat1 = SparseTensor(row=row, col=col)
    mat1.fill_cache_()

    row, col = tensor([[0, 0, 1, 2], [0, 1, 1, 0]], jnp.int64, device)
    mat2 = SparseTensor(row=row, col=col)
    mat2.fill_cache_()

    out = cat([mat1, mat2], dim=0)
    assert out.to_dense().tolist() == [
        [1, 1, 0], [0, 0, 1], [1, 1, 0], [0, 1, 0], [1, 0, 0]]
    assert out.storage.has_row()
    assert out.storage.has_rowptr()
    assert out.storage.has_rowcount()
    assert out.storage.num_cached_keys() == 1

    out = cat([mat1, mat2], dim=1)
    assert out.to_dense().tolist() == [
        [1, 1, 0, 1, 1], [0, 0, 1, 0, 1], [0, 0, 0, 1, 0]]
    assert out.storage.has_row()
    assert not out.storage.has_rowptr()
    assert out.storage.num_cached_keys() == 2

    out = cat([mat1, mat2], dim=(0, 1))
    assert out.to_dense().tolist() == [
        [1, 1, 0, 0, 0], [0, 0, 1, 0, 0], [0, 0, 0, 1, 1],
        [0, 0, 0, 0, 1], [0, 0, 0, 1, 0]]
    assert out.storage.has_row()
    assert out.storage.has_rowptr()
    assert out.storage.num_cached_keys() == 5

    value = jnp.asarray(np.random.randn(mat1.nnz(), 4), dtype=jnp.float32)
    mat1 = mat1.set_value_(value, layout="coo")
    out = cat([mat1, mat1], dim=-1)
    assert list(out.storage.value().shape) == [mat1.nnz(), 8]
    assert out.storage.has_row()
    assert out.storage.has_rowptr()
    assert out.storage.num_cached_keys() == 5


# ---------------------------------------------------------------------------
# coalesce functional (test_coalesce.py oracle)
# ---------------------------------------------------------------------------
def test_coalesce():
    row = jnp.asarray([1, 0, 1, 0, 2, 1])
    col = jnp.asarray([0, 1, 1, 1, 0, 0])
    index = jnp.stack([row, col])

    index, _ = coalesce(index, None, m=3, n=2)
    assert index.tolist() == [[0, 1, 1, 2], [1, 0, 1, 0]]


def test_coalesce_add():
    row = jnp.asarray([1, 0, 1, 0, 2, 1])
    col = jnp.asarray([0, 1, 1, 1, 0, 0])
    index = jnp.stack([row, col])
    value = jnp.asarray([[1, 2], [2, 3], [3, 4], [4, 5], [5, 6], [6, 7]])

    index, value = coalesce(index, value, m=3, n=2)
    assert index.tolist() == [[0, 1, 1, 2], [1, 0, 1, 0]]
    assert value.tolist() == [[6, 8], [7, 9], [3, 4], [5, 6]]


def test_coalesce_max():
    row = jnp.asarray([1, 0, 1, 0, 2, 1])
    col = jnp.asarray([0, 1, 1, 1, 0, 0])
    index = jnp.stack([row, col])
    value = jnp.asarray([[1, 2], [2, 3], [3, 4], [4, 5], [5, 6], [6, 7]])

    index, value = coalesce(index, value, m=3, n=2, op="max")
    assert index.tolist() == [[0, 1, 1, 2], [1, 0, 1, 0]]
    assert value.tolist() == [[4, 5], [6, 7], [3, 4], [5, 6]]


# ---------------------------------------------------------------------------
# reduce (test_reduce.py oracle)
# ---------------------------------------------------------------------------
@pytest.fixture
def reduce_tensor():
    row = jnp.asarray([1, 0, 1, 0, 2, 1])
    col = jnp.asarray([0, 1, 1, 1, 0, 0])
    value = jnp.asarray([[1, 2], [2, 3], [3, 4], [4, 5], [5, 6], [6, 7]])
    return SparseTensor(row=row, col=col, value=value), value


def test_reduce_sum(reduce_tensor):
    t, value = reduce_tensor
    assert int(t.sum()) == int(value.sum())


def test_reduce_mean(reduce_tensor):
    t, value = reduce_tensor
    assert float(t.mean()) == float(value.mean())


def test_reduce_max(reduce_tensor):
    t, value = reduce_tensor
    assert int(t.max()) == int(value.max())


def test_reduce_min(reduce_tensor):
    t, value = reduce_tensor
    assert int(t.min()) == int(value.min())


def test_reduce_dims(reduce_tensor):
    t, value = reduce_tensor
    dense = np.asarray(t.to_dense())  # (3, 2, 2) dense with dup-sum
    np.testing.assert_array_equal(np.asarray(t.sum(dim=1)),
                                  dense.sum(axis=1))
    np.testing.assert_array_equal(np.asarray(t.sum(dim=0)),
                                  dense.sum(axis=0))


# ---------------------------------------------------------------------------
# transpose (test_transpose.py oracle)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,device", product(dtypes, devices))
def test_transpose_matrix(dtype, device):
    maybe_skip_testing(dtype, device)
    set_testing_device(device)

    row = jnp.asarray([1, 0, 1, 2])
    col = jnp.asarray([0, 1, 1, 0])
    index = jnp.stack([row, col])
    value = tensor([1, 2, 3, 4], dtype, device)

    index, value = transpose(index, value, m=3, n=2)
    assert index.tolist() == [[0, 0, 1, 1], [1, 2, 0, 1]]
    np.testing.assert_array_equal(np.asarray(value),
                                  np.asarray(tensor([1, 4, 2, 3], dtype,
                                                    device)))


@pytest.mark.parametrize("dtype,device", product(dtypes, devices))
def test_transpose(dtype, device):
    maybe_skip_testing(dtype, device)
    set_testing_device(device)

    row = jnp.asarray([1, 0, 1, 0, 2, 1])
    col = jnp.asarray([0, 1, 1, 1, 0, 0])
    index = jnp.stack([row, col])
    value = tensor([[1, 2], [2, 3], [3, 4], [4, 5], [5, 6], [6, 7]], dtype,
                   device)

    index, value = transpose(index, value, m=3, n=2)
    assert index.tolist() == [[0, 0, 1, 1], [1, 2, 0, 1]]
    np.testing.assert_array_equal(
        np.asarray(value),
        np.asarray(tensor([[7, 9], [5, 6], [6, 8], [3, 4]], dtype, device)))


def test_t_method_roundtrip():
    mat = SparseTensor.from_dense(
        jnp.asarray([[1.0, 0, 2], [0, 3, 0], [4, 0, 0], [0, 5, 6]]))
    mat.fill_cache_()
    t = mat.t()
    np.testing.assert_array_equal(np.asarray(t.to_dense()),
                                  np.asarray(mat.to_dense()).T)
    assert t.storage.num_cached_keys() == 5  # caches swap, not drop
    back = t.t()
    assert back == mat


# ---------------------------------------------------------------------------
# eye (test_eye.py oracle)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,device", product(dtypes, devices))
def test_eye(dtype, device):
    maybe_skip_testing(dtype, device)
    set_testing_device(device)

    mat = SparseTensor.eye(3, dtype=dtype, device=device)
    assert mat.storage.sparse_sizes() == (3, 3)
    assert mat.storage.row().tolist() == [0, 1, 2]
    assert mat.storage.rowptr().tolist() == [0, 1, 2, 3]
    assert mat.storage.col().tolist() == [0, 1, 2]
    np.testing.assert_array_equal(np.asarray(mat.storage.value()),
                                  np.asarray(tensor([1, 1, 1], dtype,
                                                    device)))
    assert mat.storage.value().dtype == jnp.dtype(dtype)
    assert mat.storage.num_cached_keys() == 0

    mat = SparseTensor.eye(3, has_value=False, device=device)
    assert mat.storage.value() is None
    assert mat.storage.num_cached_keys() == 0

    mat = SparseTensor.eye(3, 4, fill_cache=True, device=device)
    assert mat.storage.sparse_sizes() == (3, 4)
    assert mat.storage.row().tolist() == [0, 1, 2]
    assert mat.storage.rowptr().tolist() == [0, 1, 2, 3]
    assert mat.storage.num_cached_keys() == 5
    assert mat.storage.rowcount().tolist() == [1, 1, 1]
    assert mat.storage.colptr().tolist() == [0, 1, 2, 3, 3]
    assert mat.storage.colcount().tolist() == [1, 1, 1, 0]
    assert mat.storage.csr2csc().tolist() == [0, 1, 2]
    assert mat.storage.csc2csr().tolist() == [0, 1, 2]

    mat = SparseTensor.eye(4, 3, fill_cache=True, device=device)
    assert mat.storage.sparse_sizes() == (4, 3)
    assert mat.storage.row().tolist() == [0, 1, 2]
    assert mat.storage.rowptr().tolist() == [0, 1, 2, 3, 3]
    assert mat.storage.num_cached_keys() == 5
    assert mat.storage.rowcount().tolist() == [1, 1, 1, 0]
    assert mat.storage.colptr().tolist() == [0, 1, 2, 3]
    assert mat.storage.colcount().tolist() == [1, 1, 1]


def test_eye_functional():
    index, value = eye(3)
    assert index.tolist() == [[0, 1, 2], [0, 1, 2]]
    assert value.tolist() == [1, 1, 1]


# ---------------------------------------------------------------------------
# permute (test_permute.py oracle)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("device", devices)
def test_permute(device):
    set_testing_device(device)

    row, col = tensor([[0, 0, 1, 2, 2], [0, 1, 0, 1, 2]], jnp.int64, device)
    value = tensor([1, 2, 3, 4, 5], jnp.float32, device)
    adj = SparseTensor(row=row, col=col, value=value)

    row, col, value = adj.permute(jnp.asarray([1, 0, 2])).coo()
    assert row.tolist() == [0, 1, 1, 2, 2]
    assert col.tolist() == [1, 0, 1, 0, 2]
    assert value.tolist() == [3, 2, 1, 4, 5]


# ---------------------------------------------------------------------------
# operator overloads (test_overload.py oracle)
# ---------------------------------------------------------------------------
def test_overload():
    row = jnp.asarray([0, 1, 1, 2, 2])
    col = jnp.asarray([1, 0, 2, 1, 2])
    mat = SparseTensor(row=row, col=col)

    other = jnp.asarray([1, 2, 3]).reshape(3, 1)
    other + mat
    mat + other
    other * mat
    mat * other

    other = jnp.asarray([1, 2, 3]).reshape(1, 3)
    other + mat
    mat + other
    other * mat
    mat * other


# ---------------------------------------------------------------------------
# narrow / select behaviors beyond __getitem__
# ---------------------------------------------------------------------------
def test_narrow_value_dim():
    row = jnp.asarray([0, 1])
    col = jnp.asarray([1, 0])
    value = jnp.arange(8.0).reshape(2, 4)
    mat = SparseTensor(row=row, col=col, value=value)
    out = mat.narrow(2, 1, 2)
    assert out.storage.value().tolist() == [[1.0, 2.0], [5.0, 6.0]]


def test_narrow_diag_inverts_cat_diag():
    m1 = SparseTensor.from_dense(jnp.asarray([[1.0, 2], [0, 3]]))
    m2 = SparseTensor.from_dense(jnp.asarray([[4.0, 0, 5], [0, 6, 0]]))
    m1.fill_cache_()
    m2.fill_cache_()
    stacked = cat([m1, m2], dim=(0, 1))
    back = stacked.__narrow_diag__((2, 2), (2, 3))
    assert back == m2
