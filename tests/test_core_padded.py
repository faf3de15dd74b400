"""PaddedCOO (static-shape jit core) coverage — the device compute path the
reference has no analogue of (SURVEY.md §7 design note 1)."""
import jax
import jax.numpy as jnp
import numpy as np

from paddle_sparse_jax import SparseTensor
from paddle_sparse_jax.core import PaddedCOO


def _mat():
    dense = jnp.asarray([[1.0, 0, 2], [0, 3, 0], [0, 4, 5], [0, 0, 0]])
    return SparseTensor.from_dense(dense), np.asarray(dense)


def test_roundtrip_with_padding():
    mat, dense = _mat()
    padded = PaddedCOO.from_eager(mat, capacity=12)
    assert padded.capacity == 12
    assert int(padded.nnz) == 5
    back = padded.to_eager()
    assert back == mat


def test_spmm_padded_jit():
    mat, dense = _mat()
    padded = PaddedCOO.from_eager(mat, capacity=16)
    X = jnp.asarray(np.random.default_rng(0).standard_normal((3, 4)),
                    jnp.float32)

    @jax.jit
    def run(p, x):
        return p.spmm(x)

    np.testing.assert_allclose(np.asarray(run(padded, X)),
                               dense @ np.asarray(X), rtol=1e-5, atol=1e-6)


def test_spmm_padded_grad():
    mat, dense = _mat()
    padded = PaddedCOO.from_eager(mat, capacity=16)
    X = jnp.ones((3, 2), jnp.float32)

    def loss(value):
        p = PaddedCOO(row=padded.row, col=padded.col, value=value,
                      nnz=padded.nnz, shape=padded.shape)
        return p.spmm(X).sum()

    g = jax.grad(loss)(padded.value)
    # gradient of padding slots must be exactly zero (dead row + clamped col
    # feeds a dead output slot)
    assert np.asarray(g)[int(padded.nnz):].tolist() == [0.0] * (16 - 5)
    # real slots: d/dval[e] = sum_k X[col[e],k] = 2 for all-ones X
    np.testing.assert_allclose(np.asarray(g)[:5], 2.0)


def test_transpose_padded():
    mat, dense = _mat()
    padded = PaddedCOO.from_eager(mat, capacity=10)
    t = jax.jit(lambda p: p.transpose())(padded)
    assert t.shape == (3, 4)
    back = t.to_eager()
    np.testing.assert_array_equal(np.asarray(back.to_dense()), dense.T)


def test_coalesce_padded():
    row = jnp.asarray([0, 0, 1, 1, 1], jnp.int32)
    col = jnp.asarray([1, 1, 0, 2, 2], jnp.int32)
    val = jnp.asarray([1.0, 2, 3, 4, 5])
    padded = PaddedCOO.from_arrays(row, col, val, (3, 3), capacity=8)

    out = jax.jit(lambda p: p.coalesce())(padded)
    assert int(out.nnz) == 3
    eager = out.to_eager()
    assert eager.storage.row().tolist() == [0, 1, 1]
    assert eager.storage.col().tolist() == [1, 0, 2]
    assert eager.storage.value().tolist() == [3.0, 3.0, 9.0]
    # padding slots canonical
    assert out.row[3:].tolist() == [3] * 5
    assert out.col[3:].tolist() == [3] * 5
    assert out.value[3:].tolist() == [0.0] * 5


def test_degree():
    mat, dense = _mat()
    padded = PaddedCOO.from_eager(mat, capacity=9)
    np.testing.assert_array_equal(np.asarray(padded.degree()),
                                  (dense != 0).sum(1))
