"""Tests for the padded-group (SELL) SpMM path and backend dispatch.

Correctness oracle: dense matmul (numpy) and the XLA segment formulation.
Covers ragged degrees, empty rows, value-less operands, rectangular
shapes, gradients, and the platform-keyed auto dispatch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_sparse_jax.ops import spmm as spmm_mod
from paddle_sparse_jax.ops.spmm import spmm_coo
from paddle_sparse_jax.ops.spmm_sell import make_sell_plan, spmm_sell


def _rand_graph(rng, M, N, nnz, has_val=True, dtype=np.float32):
    row = np.sort(rng.integers(0, M, nnz)).astype(np.int32)
    col = rng.integers(0, N, nnz).astype(np.int32)
    val = rng.normal(size=nnz).astype(dtype) if has_val else None
    return row, col, val


def _dense(row, col, val, M, N):
    A = np.zeros((M, N), np.float64)
    np.add.at(A, (row, col),
              val if val is not None else np.ones(len(row)))
    return A


@pytest.mark.parametrize("M,N,nnz,K,G,has_val", [
    (50, 40, 300, 16, 4, True),
    (7, 9, 5, 8, 32, True),        # group larger than any degree
    (100, 100, 1000, 32, 8, False),
    (3, 3, 1, 4, 8, True),         # near-empty
    (64, 80, 900, 24, 32, True),   # rectangular, K not lane-aligned
    (128, 128, 4000, 128, 32, True),  # high degree (multi-group rows)
])
def test_sell_forward_matches_dense(M, N, nnz, K, G, has_val):
    rng = np.random.default_rng(M * 1000 + nnz)
    row, col, val = _rand_graph(rng, M, N, nnz, has_val)
    x = rng.normal(size=(N, K)).astype(np.float32)
    plan, s = make_sell_plan(row, col, M, N, group=G, feat_dim=K)
    v = None if val is None else jnp.asarray(val)
    out = np.asarray(spmm_sell(plan, s, v, jnp.asarray(x)))
    want = _dense(row, col, val, M, N) @ x
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)


def test_sell_empty_rows_zero():
    # rows 0 and 3 empty; row 2 has all edges
    row = np.array([1, 2, 2, 2, 4], np.int32)
    col = np.array([0, 1, 2, 0, 1], np.int32)
    val = np.array([1., 2., 3., 4., 5.], np.float32)
    x = np.eye(3, dtype=np.float32)
    plan, s = make_sell_plan(row, col, 5, 3, group=8, feat_dim=3)
    out = np.asarray(spmm_sell(plan, s, jnp.asarray(val), jnp.asarray(x)))
    want = _dense(row, col, val, 5, 3) @ x
    np.testing.assert_allclose(out, want, rtol=1e-6)
    assert np.all(out[0] == 0) and np.all(out[3] == 0)


def test_sell_grads_match_xla():
    rng = np.random.default_rng(7)
    M, N, nnz, K = 30, 25, 200, 8
    row, col, val = _rand_graph(rng, M, N, nnz)
    x = rng.normal(size=(N, K)).astype(np.float32)
    g = rng.normal(size=(M, K)).astype(np.float32)
    plan, s = make_sell_plan(row, col, M, N, group=8, feat_dim=K)

    def loss_sell(v, xx):
        return (spmm_sell(plan, s, v, xx) * g).sum()

    def loss_xla(v, xx):
        return (spmm_coo(jnp.asarray(row), jnp.asarray(col), v, xx, M,
                         "sum", backend="xla") * g).sum()

    dv1, dx1 = jax.grad(loss_sell, (0, 1))(jnp.asarray(val),
                                           jnp.asarray(x))
    dv2, dx2 = jax.grad(loss_xla, (0, 1))(jnp.asarray(val),
                                          jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(dv1), np.asarray(dv2),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(dx1), np.asarray(dx2),
                               rtol=1e-4, atol=1e-5)


def test_sell_backend_via_spmm_coo():
    rng = np.random.default_rng(3)
    M, N, nnz, K = 40, 40, 300, 16
    row, col, val = _rand_graph(rng, M, N, nnz)
    x = rng.normal(size=(N, K)).astype(np.float32)
    out = spmm_coo(jnp.asarray(row), jnp.asarray(col), jnp.asarray(val),
                   jnp.asarray(x), M, "sum", backend="sell")
    want = spmm_coo(jnp.asarray(row), jnp.asarray(col), jnp.asarray(val),
                    jnp.asarray(x), M, "sum", backend="xla")
    np.testing.assert_allclose(np.asarray(out), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


def test_sell_plan_cache_reused():
    rng = np.random.default_rng(4)
    row, col, val = _rand_graph(rng, 20, 20, 100)
    rowj, colj = jnp.asarray(row), jnp.asarray(col)
    x = jnp.asarray(rng.normal(size=(20, 8)).astype(np.float32))
    p1 = spmm_mod._cached_sell_plan(rowj, colj, 20, 20, 8)
    p2 = spmm_mod._cached_sell_plan(rowj, colj, 20, 20, 8)
    assert p1[0] is p2[0] and p1[1] is p2[1]
    _ = spmm_coo(rowj, colj, jnp.asarray(val), x, 20, "sum",
                 backend="sell")


def test_auto_dispatch_is_platform_keyed(monkeypatch):
    """Under jit on a GPU platform, auto must pick the kernel path even
    for tracers (tracer inputs must not fall back to XLA)."""
    from paddle_sparse_jax.ops.kernels import spmm_pallas as kmod
    monkeypatch.setattr(kmod, "_lowering_platform", lambda: "gpu")
    rng = np.random.default_rng(5)
    M, N, nnz, K = 32, 32, 200, 128
    row, col, val = _rand_graph(rng, M, N, nnz)
    x = rng.normal(size=(N, K)).astype(np.float32)

    def f(r, c, v, xx):
        return spmm_coo(r, c, v, xx, M, "sum", backend="auto")

    jaxpr = jax.make_jaxpr(f)(jnp.asarray(row), jnp.asarray(col),
                              jnp.asarray(val), jnp.asarray(x))
    assert "pallas_call" in str(jaxpr), (
        "jitted auto dispatch on the GPU must lower to the kernel")

    # auto must NOT pick sell: it stays available behind backend="sell"
    # only
    calls = {}
    real = spmm_mod._cached_sell_plan

    def spy(*a, **k):
        calls["n"] = calls.get("n", 0) + 1
        return real(*a, **k)

    monkeypatch.setattr(spmm_mod, "_cached_sell_plan", spy)
    jax.make_jaxpr(f)(jnp.asarray(row), jnp.asarray(col),
                      jnp.asarray(val), jnp.asarray(x))
    assert calls.get("n") is None


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sell_dtype_follows_x(dtype):
    rng = np.random.default_rng(11)
    row, col, val = _rand_graph(rng, 20, 20, 80, dtype=dtype)
    x = rng.normal(size=(20, 8)).astype(dtype)
    plan, s = make_sell_plan(row, col, 20, 20, group=8, feat_dim=8)
    out = spmm_sell(plan, s, jnp.asarray(val), jnp.asarray(x))
    assert out.dtype == x.dtype
    want = _dense(row, col, val, 20, 20) @ x
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-4,
                               atol=1e-4)


def test_sell_grid_values_roundtrip_and_forward():
    """The format-native (G, ng) value grid: pad/unpad round trip and
    forward parity with the 1-D path."""
    from paddle_sparse_jax.ops.spmm_sell import pad_values, unpad_values
    rng = np.random.default_rng(13)
    M, N, nnz, K, G = 40, 35, 260, 16, 8
    row, col, val = _rand_graph(rng, M, N, nnz)
    x = rng.normal(size=(N, K)).astype(np.float32)
    plan, s = make_sell_plan(row, col, M, N, group=G, feat_dim=K)
    grid = pad_values(s, jnp.asarray(val), group=G)
    assert grid.shape[0] == G
    back = np.asarray(unpad_values(s, grid, group=G))
    np.testing.assert_array_equal(back, val)
    out_grid = np.asarray(spmm_sell(plan, s, grid, jnp.asarray(x)))
    out_1d = np.asarray(spmm_sell(plan, s, jnp.asarray(val),
                                  jnp.asarray(x)))
    np.testing.assert_allclose(out_grid, out_1d, rtol=1e-6)


def test_sell_grid_grads_match_xla():
    """Grid-layout gradients (d_value in grid layout, d_x via the static
    transpose slot map) match the XLA formulation."""
    from paddle_sparse_jax.ops.spmm_sell import pad_values, unpad_values
    rng = np.random.default_rng(17)
    M, N, nnz, K, G = 30, 25, 200, 8, 8
    row, col, val = _rand_graph(rng, M, N, nnz)
    x = rng.normal(size=(N, K)).astype(np.float32)
    g = rng.normal(size=(M, K)).astype(np.float32)
    plan, s = make_sell_plan(row, col, M, N, group=G, feat_dim=K)
    grid = pad_values(s, jnp.asarray(val), group=G)

    def loss_grid(vg, xx):
        return (spmm_sell(plan, s, vg, xx) * g).sum()

    def loss_xla(v, xx):
        return (spmm_coo(jnp.asarray(row), jnp.asarray(col), v, xx, M,
                         "sum", backend="xla") * g).sum()

    dvg, dx1 = jax.grad(loss_grid, (0, 1))(grid, jnp.asarray(x))
    dv2, dx2 = jax.grad(loss_xla, (0, 1))(jnp.asarray(val),
                                          jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(dx1), np.asarray(dx2),
                               rtol=1e-4, atol=1e-5)
    # grid grad maps back to the COO-ordered grad
    dv1 = np.asarray(unpad_values(s, dvg, group=G))
    np.testing.assert_allclose(dv1, np.asarray(dv2), rtol=1e-4,
                               atol=1e-5)
    # pad slots carry zero gradient
    eid = np.asarray(s.eid).reshape(-1, G).T
    assert np.all(np.asarray(dvg)[eid < 0] == 0)


def test_sell_identity_level2():
    """Uniform-degree graph with G == degree: zero padding, one group per
    row, level-2 skipped (plan.l2_identity) — results still exact."""
    rng = np.random.default_rng(23)
    M = N = 48
    deg, G = 8, 8
    row = np.repeat(np.arange(M, dtype=np.int32), deg)
    col = rng.integers(0, N, M * deg).astype(np.int32)
    val = rng.normal(size=M * deg).astype(np.float32)
    x = rng.normal(size=(N, 16)).astype(np.float32)
    plan, s = make_sell_plan(row, col, M, N, group=G, feat_dim=16)
    assert plan.l2_identity
    out = np.asarray(spmm_sell(plan, s, jnp.asarray(val), jnp.asarray(x)))
    want = _dense(row, col, val, M, N) @ x
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)
    # gradients flow through the identity path too
    dv, dx = jax.grad(lambda v, xx: spmm_sell(plan, s, v, xx).sum(),
                      (0, 1))(jnp.asarray(val), jnp.asarray(x))
    dv2, dx2 = jax.grad(
        lambda v, xx: spmm_coo(jnp.asarray(row), jnp.asarray(col), v, xx,
                               M, "sum", backend="xla").sum(),
        (0, 1))(jnp.asarray(val), jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(dv), np.asarray(dv2), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(dx), np.asarray(dx2), rtol=1e-4,
                               atol=1e-5)


def test_sell_auto_group_cpu_default():
    rng = np.random.default_rng(29)
    row, col, val = _rand_graph(rng, 30, 30, 200)
    plan, s = make_sell_plan(row, col, 30, 30, feat_dim=8)
    assert plan.group >= 1   # auto resolved to a concrete int
    x = rng.normal(size=(30, 8)).astype(np.float32)
    out = np.asarray(spmm_sell(plan, s, jnp.asarray(val), jnp.asarray(x)))
    want = _dense(row, col, val, 30, 30) @ x
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)
