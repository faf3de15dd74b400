"""Source-segmented SpMM (ops/spmm_seg2.py): numpy-oracle conformance +
gradient checks, multi-segment geometry forced via the ``sr`` override
(the kernel runs in interpret mode on the CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_sparse_jax.ops.spmm_seg2 import (make_seg2_plan, pack_values,
                                             spmm_seg2, unpack_values)

rng = np.random.default_rng(42)


def _graph(M, N, nnz):
    row = np.sort(rng.integers(0, M, nnz)).astype(np.int32)
    col = rng.integers(0, N, nnz).astype(np.int32)
    return row, col


@pytest.mark.parametrize("M,N,nnz,K,sr", [
    (300, 200, 2500, 128, 64),     # many segments
    (130, 500, 1800, 128, 512),    # S=1 boundary-ish
    (257, 129, 900, 128, 32),      # non-pow2 dims, tiny segments
])
def test_seg2_forward_oracle(M, N, nnz, K, sr):
    row, col = _graph(M, N, nnz)
    val = rng.standard_normal(nnz).astype(np.float32)
    x = rng.standard_normal((N, K)).astype(np.float32)

    plan, s = make_seg2_plan(row, col, M, N, feat_dim=K, sr=sr, stream="f32")
    packed = pack_values(s, jnp.asarray(val))
    # pack/unpack round-trip
    np.testing.assert_array_equal(
        np.asarray(unpack_values(s, packed)), val)

    out = spmm_seg2(plan, s, packed, jnp.asarray(x))
    want = np.zeros((M, K), np.float64)
    np.add.at(want, row, val[:, None].astype(np.float64) * x[col])
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-4,
                               atol=1e-4)


def test_seg2_forward_no_values():
    M, N, nnz, K = 200, 300, 2000, 128
    row, col = _graph(M, N, nnz)
    x = rng.standard_normal((N, K)).astype(np.float32)
    plan, s = make_seg2_plan(row, col, M, N, feat_dim=K, sr=128, stream="f32")
    out = spmm_seg2(plan, s, None, jnp.asarray(x))
    want = np.zeros((M, K), np.float64)
    np.add.at(want, row, x[col].astype(np.float64))
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-4,
                               atol=1e-4)


def test_seg2_grads_match_xla():
    M, N, nnz, K = 220, 180, 2100, 128
    row, col = _graph(M, N, nnz)
    val = rng.standard_normal(nnz).astype(np.float32)
    x = rng.standard_normal((N, K)).astype(np.float32)
    g = rng.standard_normal((M, K)).astype(np.float32)

    plan, s = make_seg2_plan(row, col, M, N, feat_dim=K, sr=64, stream="f32")
    packed = pack_values(s, jnp.asarray(val))

    def loss(pv, xx):
        return (spmm_seg2(plan, s, pv, xx) * jnp.asarray(g)).sum()

    d_pv, d_x = jax.grad(loss, argnums=(0, 1))(packed, jnp.asarray(x))
    d_val = np.asarray(unpack_values(s, d_pv))

    # oracle: d_val[e] = g[row[e]] . x[col[e]];  d_x = A^T @ g
    want_dv = (g[row].astype(np.float64) * x[col]).sum(axis=1)
    want_dx = np.zeros((N, K), np.float64)
    np.add.at(want_dx, col, val[:, None].astype(np.float64) * g[row])
    np.testing.assert_allclose(d_val, want_dv, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(d_x), want_dx, rtol=1e-4,
                               atol=1e-4)


def test_seg2_empty_rows_and_tail():
    """Rows with no edges and a non-multiple-of-chunk tail stay exact."""
    M, N, K = 140, 90, 128
    row = np.array([0, 0, 5, 5, 5, 139], np.int32)
    col = np.array([1, 89, 0, 44, 44, 7], np.int32)
    val = rng.standard_normal(6).astype(np.float32)
    x = rng.standard_normal((N, K)).astype(np.float32)
    plan, s = make_seg2_plan(row, col, M, N, feat_dim=K, sr=32, stream="f32")
    packed = pack_values(s, jnp.asarray(val))
    out = spmm_seg2(plan, s, packed, jnp.asarray(x))
    want = np.zeros((M, K), np.float64)
    np.add.at(want, row, val[:, None].astype(np.float64) * x[col])
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-4,
                               atol=1e-4)


def test_seg2_unsorted_rows_rejected():
    row = np.array([3, 1, 2], np.int32)
    col = np.array([0, 1, 2], np.int32)
    with pytest.raises(ValueError, match="sorted ascending"):
        make_seg2_plan(row, col, 4, 4, feat_dim=64)


def test_seg2_empty_matrix():
    """nnz=0 structures plan and run to a zero output."""
    from paddle_sparse_jax.ops.spmm_seg2 import (make_seg2_plan,
                                                 spmm_seg2)
    row = jnp.zeros((0,), jnp.int32)
    col = jnp.zeros((0,), jnp.int32)
    plan, s = make_seg2_plan(row, col, 8, 8, feat_dim=16, sr=8)
    out = spmm_seg2(plan, s, None, jnp.ones((8, 16), jnp.float32))
    assert out.shape == (8, 16)
    np.testing.assert_allclose(np.asarray(out), 0.0)


@pytest.mark.parametrize("sr", [None, 32])
def test_seg2_segment_accumulation(sr):
    """One segment (plain CSR; the backward is the fused transpose +
    value-gradient pass) and many segments (each a kernel pass adding
    into the running output; separate SDDMM) agree with the oracle."""
    M, N, nnz, K = 150, 170, 1600, 48
    row, col = _graph(M, N, nnz)
    val = rng.standard_normal(nnz).astype(np.float32)
    x = rng.standard_normal((N, K)).astype(np.float32)
    g = rng.standard_normal((M, K)).astype(np.float32)
    plan, s = make_seg2_plan(row, col, M, N, feat_dim=K, sr=sr,
                             stream="f32")
    assert (plan.S == 1) == (sr is None) and (plan.S_t == 1) == (sr is None)
    packed = pack_values(s, jnp.asarray(val))

    def loss(pv, xx):
        return (spmm_seg2(plan, s, pv, xx) * jnp.asarray(g)).sum()

    out = spmm_seg2(plan, s, packed, jnp.asarray(x))
    want = np.zeros((M, K), np.float64)
    np.add.at(want, row, val[:, None].astype(np.float64) * x[col])
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-4, atol=1e-4)
    d_pv, d_x = jax.grad(loss, argnums=(0, 1))(packed, jnp.asarray(x))
    want_dv = (g[row].astype(np.float64) * x[col]).sum(axis=1)
    want_dx = np.zeros((N, K), np.float64)
    np.add.at(want_dx, col, val[:, None].astype(np.float64) * g[row])
    np.testing.assert_allclose(np.asarray(unpack_values(s, d_pv)), want_dv,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(d_x), want_dx, rtol=1e-4,
                               atol=1e-4)
