"""Local/residual split SpMM (round 5): forward + grads vs dense."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_sparse_jax.ops.spmm_split import (make_split_plan,
                                              pack_values_split,
                                              spmm_split,
                                              unpack_values_split)


def _clustered(M, deg, block, p_in, seed=0):
    rng = np.random.default_rng(seed)
    nnz = M * deg
    row = np.repeat(np.arange(M), deg)
    cu = row // block
    v_in = np.minimum(cu * block + rng.integers(0, block, nnz), M - 1)
    v_out = rng.integers(0, M, nnz)
    col = np.where(rng.random(nnz) < p_in, v_in, v_out)
    order = np.lexsort((col, row))
    return row[order].astype(np.int32), col[order].astype(np.int32)


def test_split_matches_dense_and_grads():
    M, K = 256, 64
    row, col = _clustered(M, 6, 32, 0.8)
    nnz = row.size
    rng = np.random.default_rng(1)
    val = rng.standard_normal(nnz).astype(np.float32)
    X = rng.standard_normal((M, K)).astype(np.float32)

    plan, s = make_split_plan(jnp.asarray(row), jnp.asarray(col), M, M,
                              feat_dim=K, block=32, sr=32)
    assert int(s.idx_local.shape[0]) > 0
    assert int(s.idx_resid.shape[0]) > 0
    packed = pack_values_split(s, jnp.asarray(val))
    # pack/unpack round-trips
    np.testing.assert_allclose(
        np.asarray(unpack_values_split(s, packed)), val)

    dense = np.zeros((M, M), np.float32)
    np.add.at(dense, (row, col), val)
    out = spmm_split(plan, s, packed, jnp.asarray(X))
    np.testing.assert_allclose(np.asarray(out), dense @ X, rtol=1e-4,
                               atol=1e-4)

    def loss(pv, x):
        return (spmm_split(plan, s, pv, x) ** 2).sum()

    (d_pvL, d_pvR), d_x = jax.grad(loss, argnums=(0, 1))(
        packed, jnp.asarray(X))
    g = 2.0 * (dense @ X)
    np.testing.assert_allclose(np.asarray(d_x), dense.T @ g, rtol=1e-3,
                               atol=1e-3)
    want_dv = (g[row] * X[col]).sum(axis=1)
    got_dv = np.asarray(unpack_values_split(s, (d_pvL, d_pvR)))
    np.testing.assert_allclose(got_dv, want_dv, rtol=1e-3, atol=1e-3)


def test_split_rejects_one_sided():
    row = jnp.asarray([0, 1, 2], jnp.int32)
    col = jnp.asarray([0, 1, 2], jnp.int32)
    with pytest.raises(ValueError, match="BOTH sides"):
        make_split_plan(row, col, 4, 4, feat_dim=8, block=4)
