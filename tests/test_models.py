"""End-to-end model milestone (SURVEY.md §7 step 3): GNN forward+backward
using only this library's ops, validated against a dense reference."""
import jax
import jax.numpy as jnp
import numpy as np

from paddle_sparse_jax import SparseTensor
from paddle_sparse_jax.core import PaddedCOO
from paddle_sparse_jax.models import (APPNP, GAT, GCN, GIN, GraphSAGE,
                                      edge_softmax, gcn_normalize,
                                      init_appnp, init_gat, init_gcn,
                                      init_gin, init_sage)

rng = np.random.default_rng(11)


def _graph(n=32, feat=8):
    dense = (rng.random((n, n)) < 0.15).astype(np.float32)
    np.fill_diagonal(dense, 1.0)  # self loops
    adj = PaddedCOO.from_eager(
        SparseTensor.from_dense(jnp.asarray(dense)), capacity=512)
    x = jnp.asarray(rng.standard_normal((n, feat)), jnp.float32)
    return adj, dense, x


def test_gcn_forward_matches_dense():
    adj, dense, x = _graph()
    adj_n = gcn_normalize(adj)
    params = init_gcn(jax.random.PRNGKey(0), 8, 16, 4)
    out = jax.jit(GCN)(params, adj_n, x)
    assert out.shape == (32, 4)

    deg = dense.sum(1)
    dinv = 1 / np.sqrt(deg)
    A_norm = dense * dinv[:, None] * dinv[None, :]
    h = np.maximum(
        A_norm @ np.asarray(x) @ np.asarray(params["layers"][0]["w"])
        + np.asarray(params["layers"][0]["b"]), 0)
    expected = (A_norm @ h @ np.asarray(params["layers"][1]["w"])
                + np.asarray(params["layers"][1]["b"]))
    np.testing.assert_allclose(np.asarray(out), expected, rtol=1e-4,
                               atol=1e-4)


def test_gcn_train_step_decreases_loss():
    adj, dense, x = _graph()
    adj_n = gcn_normalize(adj)
    params = init_gcn(jax.random.PRNGKey(0), 8, 16, 4)
    y = jnp.asarray(rng.integers(0, 4, 32))

    @jax.jit
    def loss_fn(params):
        logits = GCN(params, adj_n, x)
        logp = jax.nn.log_softmax(logits)
        return -jnp.take_along_axis(logp, y[:, None], axis=1).mean()

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    loss0, grads = grad_fn(params)
    for _ in range(20):
        loss, grads = grad_fn(params)
        params = jax.tree_util.tree_map(lambda p, g: p - 0.1 * g, params,
                                        grads)
    loss_end, _ = grad_fn(params)
    assert float(loss_end) < float(loss0)


def test_other_model_families_run():
    adj, dense, x = _graph()
    adj_n = gcn_normalize(adj)
    key = jax.random.PRNGKey(1)

    sage = GraphSAGE(init_sage(key, 8, 16, 4), adj, x)
    assert sage.shape == (32, 4) and np.isfinite(np.asarray(sage)).all()

    gin = GIN(init_gin(key, 8, 16, 4), adj, x)
    assert gin.shape == (32, 4) and np.isfinite(np.asarray(gin)).all()

    appnp = APPNP(init_appnp(key, 8, 16, 4), adj_n, x, k=5)
    assert appnp.shape == (32, 4) and np.isfinite(np.asarray(appnp)).all()

    gat = jax.jit(GAT)(init_gat(key, 8, 16, 4, heads=2), adj, x)
    assert gat.shape == (32, 4) and np.isfinite(np.asarray(gat)).all()


def test_edge_softmax_rows_sum_to_one():
    adj, dense, x = _graph()
    logits = jnp.asarray(
        rng.standard_normal((adj.capacity, 3)), jnp.float32)
    att = edge_softmax(adj, logits)
    # padded edges get zero weight
    assert float(jnp.abs(jnp.where(adj.valid_mask()[:, None],
                                   0.0, att)).max()) == 0.0
    row = np.clip(np.asarray(adj.row), 0, adj.M - 1)
    sums = np.zeros((adj.M, 3), np.float64)
    np.add.at(sums, row, np.asarray(att, np.float64))
    nonempty = np.asarray(dense).sum(1) > 0
    np.testing.assert_allclose(sums[nonempty], 1.0, atol=1e-5)


def test_gat_train_step_decreases_loss():
    adj, dense, x = _graph()
    params = init_gat(jax.random.PRNGKey(3), 8, 8, 4, heads=2)
    y = jnp.asarray(rng.integers(0, 4, 32))

    @jax.jit
    def loss_fn(params):
        logits = GAT(params, adj, x)
        logp = jax.nn.log_softmax(logits)
        return -jnp.take_along_axis(logp, y[:, None], axis=1).mean()

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    loss0, _ = grad_fn(params)
    for _ in range(25):
        loss, grads = grad_fn(params)
        params = jax.tree_util.tree_map(lambda p, g: p - 0.05 * g, params,
                                        grads)
    loss_end, _ = grad_fn(params)
    assert float(loss_end) < float(loss0)
