"""Source-blocked SpMM (ops/spmm_seg.py): correctness + gradients on the
CPU (kernel in interpret mode) with tiny segments."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_sparse_jax.ops.spmm_seg import (make_seg_plan, pack_values,
                                            spmm_seg, unpack_values)

rng = np.random.default_rng(11)


def _graph(M, N, nnz):
    row = np.sort(rng.integers(0, M, nnz))
    col = rng.integers(0, N, nnz)
    order = np.lexsort((col, row))
    return row[order].astype(np.int32), col[order].astype(np.int32)


@pytest.mark.parametrize("M,N,nnz", [(300, 250, 3000), (520, 700, 5200)])
def test_seg_forward_matches_dense(M, N, nnz):
    row, col = _graph(M, N, nnz)
    val = rng.standard_normal(nnz).astype(np.float32)
    x = rng.standard_normal((N, 64)).astype(np.float32)
    plan, s = make_seg_plan(jnp.asarray(row), jnp.asarray(col), M, N,
                            feat_dim=64, target_bytes=64 * 1024,
                            seg_rows=128)
    assert plan.num_segments > 1 and plan.num_rows // plan.rows_per_block
    pv = pack_values(s, jnp.asarray(val))
    np.testing.assert_allclose(np.asarray(unpack_values(s, pv)), val)
    out = spmm_seg(plan, s, pv, jnp.asarray(x))
    want = np.zeros((M, 64), np.float32)
    np.add.at(want, row, val[:, None] * x[col])
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-4,
                               atol=1e-4)


def test_seg_forward_no_value():
    M, N, nnz = 260, 260, 2000
    row, col = _graph(M, N, nnz)
    x = rng.standard_normal((N, 64)).astype(np.float32)
    plan, s = make_seg_plan(jnp.asarray(row), jnp.asarray(col), M, N,
                            feat_dim=64, target_bytes=64 * 1024,
                            seg_rows=128)
    out = spmm_seg(plan, s, None, jnp.asarray(x))
    want = np.zeros((M, 64), np.float32)
    np.add.at(want, row, x[col])
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-4,
                               atol=1e-4)


def test_seg_grads_match_xla():
    from paddle_sparse_jax.ops.spmm import spmm_coo
    M, N, nnz, K = 280, 360, 2600, 64
    row, col = _graph(M, N, nnz)
    val = rng.standard_normal(nnz).astype(np.float32)
    x = rng.standard_normal((N, K)).astype(np.float32)
    w = jnp.asarray(rng.standard_normal((M, K)).astype(np.float32))
    plan, s = make_seg_plan(jnp.asarray(row), jnp.asarray(col), M, N,
                            feat_dim=K, target_bytes=48 * 1024,
                            seg_rows=128)
    pv = pack_values(s, jnp.asarray(val))

    def loss_seg(pvv, xx):
        return (spmm_seg(plan, s, pvv, xx) * w).sum()

    def loss_ref(v, xx):
        return (spmm_coo(jnp.asarray(row), jnp.asarray(col), v, xx,
                         num_rows=M, reduce="sum", backend="xla")
                * w).sum()

    dpv, dx1 = jax.grad(loss_seg, argnums=(0, 1))(pv, jnp.asarray(x))
    dv_ref, dx2 = jax.grad(loss_ref, argnums=(0, 1))(jnp.asarray(val),
                                                     jnp.asarray(x))
    # packed-layout gradient maps back to COO order
    np.testing.assert_allclose(np.asarray(unpack_values(s, dpv)),
                               np.asarray(dv_ref), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(dx1), np.asarray(dx2),
                               rtol=1e-4, atol=1e-4)


def test_seg_jit_with_structure_args():
    """Bench pattern: plan static, structure arrays as jit arguments."""
    M = N = 400
    row, col = _graph(M, N, 3200)
    val = rng.standard_normal(3200).astype(np.float32)
    x = rng.standard_normal((N, 64)).astype(np.float32)
    plan, s = make_seg_plan(jnp.asarray(row), jnp.asarray(col), M, N,
                            feat_dim=64, seg_rows=256)
    pv = pack_values(s, jnp.asarray(val))

    @jax.jit
    def f(s, pv, x):
        return spmm_seg(plan, s, pv, x)

    out = f(s, pv, jnp.asarray(x))
    want = np.zeros((M, 64), np.float32)
    np.add.at(want, row, val[:, None] * x[col])
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-4,
                               atol=1e-4)
