"""SpMM / SpGEMM correctness + gradients — coverage the reference lacks
entirely (its unsupported-op list, ``/root/reference/README.md:45-61``);
semantics follow upstream's documented contracts (``README.md:267-354``).
Validated against dense/scipy ground truth with jax.test_util-style
finite-difference-free exact checks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse

from paddle_sparse_jax import SparseTensor, matmul, spmm, spspmm
from paddle_sparse_jax.ops.spmm import spmm_coo

rng = np.random.default_rng(7)


def _rand_sparse(m, n, density=0.3, seed=0):
    r = np.random.default_rng(seed)
    mask = r.random((m, n)) < density
    dense = np.where(mask, r.standard_normal((m, n)), 0.0)
    return SparseTensor.from_dense(jnp.asarray(dense, jnp.float32)), dense


@pytest.mark.parametrize("reduce", ["sum", "mean", "min", "max"])
def test_spmm_dense_reduce(reduce):
    A, dense = _rand_sparse(7, 5, 0.4, seed=1)
    X = jnp.asarray(rng.standard_normal((5, 3)), jnp.float32)
    out = np.asarray(matmul(A, X, reduce=reduce))

    row, col, val = map(np.asarray, A.coo())
    expected = np.zeros((7, 3), np.float32)
    for m in range(7):
        edges = np.nonzero(row == m)[0]
        if len(edges) == 0:
            continue
        prods = val[edges, None] * np.asarray(X)[col[edges]]
        if reduce == "sum":
            expected[m] = prods.sum(0)
        elif reduce == "mean":
            expected[m] = prods.mean(0)
        elif reduce == "min":
            expected[m] = prods.min(0)
        else:
            expected[m] = prods.max(0)
    np.testing.assert_allclose(out, expected, rtol=1e-5, atol=1e-5)


def test_spmm_matches_dense():
    A, dense = _rand_sparse(10, 8, 0.3, seed=2)
    X = jnp.asarray(rng.standard_normal((8, 4)), jnp.float32)
    np.testing.assert_allclose(np.asarray(A @ X), dense @ np.asarray(X),
                               rtol=1e-5, atol=1e-5)


def test_spmm_no_value():
    A, dense = _rand_sparse(6, 6, 0.3, seed=3)
    A_struct = A.set_value(None)
    X = jnp.asarray(rng.standard_normal((6, 2)), jnp.float32)
    expected = (np.asarray(dense) != 0).astype(np.float32) @ np.asarray(X)
    np.testing.assert_allclose(np.asarray(A_struct @ X), expected,
                               rtol=1e-5, atol=1e-5)


def test_spmm_grads():
    A, dense = _rand_sparse(6, 5, 0.4, seed=4)
    row, col, val = A.coo()
    X = jnp.asarray(rng.standard_normal((5, 3)), jnp.float32)

    def loss(value, x):
        return spmm_coo(row, col, value, x, 6, "sum").sum()

    g_val, g_x = jax.grad(loss, argnums=(0, 1))(val, X)
    # d/dvalue[e] = sum_k X[col[e], k];  d/dX[n, k] = sum_{e: col[e]=n} val[e]
    np.testing.assert_allclose(np.asarray(g_val),
                               np.asarray(X)[np.asarray(col)].sum(1),
                               rtol=1e-5)
    expected_gx = np.zeros((5, 3), np.float32)
    for e in range(A.nnz()):
        expected_gx[int(col[e])] += float(val[e])
    np.testing.assert_allclose(np.asarray(g_x), expected_gx, rtol=1e-5)


def test_spmm_minmax_grads():
    A, _ = _rand_sparse(6, 5, 0.5, seed=5)
    row, col, val = A.coo()
    X = jnp.asarray(rng.standard_normal((5, 3)), jnp.float32)

    def loss(value):
        return spmm_coo(row, col, value, X, 6, "max").sum()

    g = jax.grad(loss)(val)
    assert np.isfinite(np.asarray(g)).all()
    # finite-difference spot check
    eps = 1e-3
    for e in [0, A.nnz() // 2]:
        v_plus = val.at[e].add(eps)
        v_minus = val.at[e].add(-eps)
        fd = (float(loss(v_plus)) - float(loss(v_minus))) / (2 * eps)
        np.testing.assert_allclose(float(g[e]), fd, atol=1e-2)


def test_spspmm_matches_scipy():
    A, dA = _rand_sparse(6, 7, 0.3, seed=6)
    B, dB = _rand_sparse(7, 5, 0.3, seed=7)
    C = matmul(A, B)
    np.testing.assert_allclose(np.asarray(C.to_dense()), dA @ dB,
                               rtol=1e-4, atol=1e-5)
    # result is coalesced & sorted
    assert C.is_coalesced()


def test_spspmm_structural():
    """Value-less inputs give a pattern-only (value-less) product — upstream
    semantics: structural nonzeros of A @ A, no counts."""
    A, dA = _rand_sparse(4, 4, 0.4, seed=8)
    A = A.set_value(None)
    C = matmul(A, A)
    assert not C.has_value()
    maskA = (dA != 0).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(C.to_dense()) != 0,
                                  (maskA @ maskA) != 0)


def test_spspmm_tuple_api():
    indexA = jnp.asarray([[0, 0, 1, 2, 2], [1, 2, 0, 0, 1]])
    valueA = jnp.asarray([1., 2, 3, 4, 5])
    indexB = jnp.asarray([[0, 2], [1, 0]])
    valueB = jnp.asarray([2., 4])
    indexC, valueC = spspmm(indexA, valueA, indexB, valueB, 3, 3, 2)
    A = np.zeros((3, 3)); B = np.zeros((3, 2))
    A[np.asarray(indexA[0]), np.asarray(indexA[1])] = np.asarray(valueA)
    B[np.asarray(indexB[0]), np.asarray(indexB[1])] = np.asarray(valueB)
    C = np.zeros((3, 2))
    C[np.asarray(indexC[0]), np.asarray(indexC[1])] = np.asarray(valueC)
    np.testing.assert_allclose(C, A @ B, rtol=1e-6)


def test_spmm_tuple_api():
    index = jnp.asarray([[0, 0, 1, 2, 2], [0, 2, 1, 0, 1]])
    value = jnp.asarray([1., 2, 3, 4, 5])
    matrix = jnp.asarray([[1., 4], [2, 5], [3, 6]])
    out = spmm(index, value, 3, 3, matrix)
    A = np.zeros((3, 3))
    A[np.asarray(index[0]), np.asarray(index[1])] = np.asarray(value)
    np.testing.assert_allclose(np.asarray(out), A @ np.asarray(matrix),
                               rtol=1e-6)


def test_spspmm_grads():
    """Value gradients of SpGEMM vs dense autodiff ground truth."""
    A, dA = _rand_sparse(5, 6, 0.4, seed=9)
    B, dB = _rand_sparse(6, 4, 0.4, seed=10)
    rowA, colA, valA = A.coo()
    rowB, colB, valB = B.coo()

    def sparse_loss(va, vb):
        A2 = SparseTensor(row=rowA, col=colA, value=va, sparse_sizes=(5, 6),
                          is_sorted=True, trust_data=True)
        B2 = SparseTensor(row=rowB, col=colB, value=vb, sparse_sizes=(6, 4),
                          is_sorted=True, trust_data=True)
        C = matmul(A2, B2)
        return (C.storage.value() ** 2).sum()

    gA, gB = jax.grad(sparse_loss, argnums=(0, 1))(valA, valB)

    def dense_loss(va, vb):
        Ad = jnp.zeros((5, 6)).at[rowA, colA].set(va)
        Bd = jnp.zeros((6, 4)).at[rowB, colB].set(vb)
        C = Ad @ Bd
        return (C ** 2).sum()

    gA_d, gB_d = jax.grad(dense_loss, argnums=(0, 1))(valA, valB)
    np.testing.assert_allclose(np.asarray(gA), np.asarray(gA_d), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(gB), np.asarray(gB_d), rtol=1e-4,
                               atol=1e-5)
