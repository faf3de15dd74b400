"""Graph neural network model families on the PaddedCOO core.

Pure-functional JAX models (params pytrees + apply functions): the dense
transforms are dense matmuls (tensor cores), the neighborhood
aggregations are this library's SpMM.  All apply functions are jittable and
differentiable end-to-end.
"""
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp

from ..core.matrix import PaddedCOO


# ---------------------------------------------------------------------------
# graph normalization
# ---------------------------------------------------------------------------
def gcn_normalize(adj: PaddedCOO, add_self_loops: bool = False) -> PaddedCOO:
    """Symmetric GCN normalization ``D^-1/2 (A) D^-1/2`` on the padded core.

    (Self-loops should be added on the eager side before padding —
    ``set_diag`` — so capacity stays static; ``add_self_loops`` flags that
    the caller already did.)
    """
    deg = adj.degree().astype(jnp.float32)
    inv_sqrt = jnp.where(deg > 0, jax.lax.rsqrt(jnp.maximum(deg, 1.0)), 0.0)
    value = adj.value
    if value is None:
        value = jnp.where(adj.valid_mask(), 1.0, 0.0)
    row_scale = inv_sqrt[jnp.clip(adj.row, 0, adj.M - 1)]
    col_scale = inv_sqrt[jnp.clip(adj.col, 0, adj.M - 1)]
    new_value = value * row_scale * col_scale
    return adj.with_value(new_value)


def _dense(key, d_in, d_out):
    w_key, _ = jax.random.split(key)
    scale = (2.0 / d_in) ** 0.5
    return {"w": jax.random.normal(w_key, (d_in, d_out), jnp.float32) * scale,
            "b": jnp.zeros((d_out,), jnp.float32)}


# ---------------------------------------------------------------------------
# GCN
# ---------------------------------------------------------------------------
def init_gcn(key, in_dim: int, hidden: int, out_dim: int,
             num_layers: int = 2) -> Dict[str, Any]:
    keys = jax.random.split(key, num_layers)
    dims = [in_dim] + [hidden] * (num_layers - 1) + [out_dim]
    return {"layers": [_dense(k, dims[i], dims[i + 1])
                       for i, k in enumerate(keys)]}


def GCN(params, adj: PaddedCOO, x: jax.Array) -> jax.Array:
    """Kipf-Welling GCN: ``H' = relu(A_norm @ H @ W)`` stacked."""
    h = x
    n = len(params["layers"])
    for i, layer in enumerate(params["layers"]):
        h = adj.spmm(h)
        h = h @ layer["w"] + layer["b"]
        if i < n - 1:
            h = jax.nn.relu(h)
    return h


# ---------------------------------------------------------------------------
# GraphSAGE (mean aggregator)
# ---------------------------------------------------------------------------
def init_sage(key, in_dim: int, hidden: int, out_dim: int,
              num_layers: int = 2) -> Dict[str, Any]:
    keys = jax.random.split(key, 2 * num_layers)
    dims = [in_dim] + [hidden] * (num_layers - 1) + [out_dim]
    return {"self": [_dense(keys[2 * i], dims[i], dims[i + 1])
                     for i in range(num_layers)],
            "neigh": [_dense(keys[2 * i + 1], dims[i], dims[i + 1])
                      for i in range(num_layers)]}


def GraphSAGE(params, adj: PaddedCOO, x: jax.Array) -> jax.Array:
    h = x
    n = len(params["self"])
    for i in range(n):
        agg = adj.spmm(h, reduce="mean")
        h = (h @ params["self"][i]["w"] + params["self"][i]["b"]
             + agg @ params["neigh"][i]["w"] + params["neigh"][i]["b"])
        if i < n - 1:
            h = jax.nn.relu(h)
    return h


# ---------------------------------------------------------------------------
# GIN
# ---------------------------------------------------------------------------
def init_gin(key, in_dim: int, hidden: int, out_dim: int,
             num_layers: int = 2) -> Dict[str, Any]:
    keys = jax.random.split(key, 2 * num_layers)
    dims = [in_dim] + [hidden] * (num_layers - 1) + [out_dim]
    return {"mlp1": [_dense(keys[2 * i], dims[i], dims[i + 1])
                     for i in range(num_layers)],
            "mlp2": [_dense(keys[2 * i + 1], dims[i + 1], dims[i + 1])
                     for i in range(num_layers)],
            "eps": jnp.zeros((num_layers,), jnp.float32)}


def GIN(params, adj: PaddedCOO, x: jax.Array) -> jax.Array:
    h = x
    n = len(params["mlp1"])
    for i in range(n):
        agg = adj.spmm(h)
        h = (1.0 + params["eps"][i]) * h + agg
        h = jax.nn.relu(h @ params["mlp1"][i]["w"] + params["mlp1"][i]["b"])
        h = h @ params["mlp2"][i]["w"] + params["mlp2"][i]["b"]
        if i < n - 1:
            h = jax.nn.relu(h)
    return h


# ---------------------------------------------------------------------------
# GAT (graph attention)
# ---------------------------------------------------------------------------
def edge_softmax(adj: PaddedCOO, logits: jax.Array) -> jax.Array:
    """Per-destination-row softmax over edge ``logits``.

    ``logits`` has shape ``(capacity,)`` or ``(capacity, H)`` (multi-head).
    Padded edges (``row == M`` sentinel) are masked to zero weight.  The
    row-wise max subtraction keeps the exp numerically safe; both reductions
    are sorted segment ops (row-sorted canonical layout), so XLA fuses the
    whole thing into two passes over the edge stream.
    """
    row = jnp.clip(adj.row, 0, adj.M - 1)
    valid = adj.valid_mask()
    vmask = valid.reshape(valid.shape + (1,) * (logits.ndim - 1))
    neg = jnp.asarray(-1e30, logits.dtype)
    masked = jnp.where(vmask, logits, neg)
    row_max = jax.ops.segment_max(masked, row, num_segments=adj.M,
                                  indices_are_sorted=True)
    row_max = jnp.where(jnp.isfinite(row_max), row_max, 0.0)
    e = jnp.where(vmask, jnp.exp(masked - row_max[row]), 0.0)
    denom = jax.ops.segment_sum(e, row, num_segments=adj.M,
                                indices_are_sorted=True)
    return e / jnp.maximum(denom[row], 1e-16)


def init_gat(key, in_dim: int, hidden: int, out_dim: int, heads: int = 4,
             num_layers: int = 2) -> Dict[str, Any]:
    keys = jax.random.split(key, 3 * num_layers)
    dims = [in_dim] + [hidden * heads] * (num_layers - 1) + [out_dim]
    layers = []
    for i in range(num_layers):
        h = heads if i < num_layers - 1 else 1
        d_out = hidden if i < num_layers - 1 else out_dim
        scale = (2.0 / dims[i]) ** 0.5
        layers.append({
            "w": jax.random.normal(keys[3 * i], (dims[i], h * d_out),
                                   jnp.float32) * scale,
            "a_src": jax.random.normal(keys[3 * i + 1], (h, d_out),
                                       jnp.float32) * scale,
            "a_dst": jax.random.normal(keys[3 * i + 2], (h, d_out),
                                       jnp.float32) * scale,
        })
    return {"layers": layers}


def GAT(params, adj: PaddedCOO, x: jax.Array,
        negative_slope: float = 0.2) -> jax.Array:
    """Velickovic-style graph attention network.

    Edges attend source→destination along the sparse structure: per-edge
    logits are LeakyReLU(a_dst·h[row] + a_src·h[col]); attention weights
    come from :func:`edge_softmax`; aggregation is a per-head weighted
    segment-sum (an SpMM with attention-valued entries).  Heads are
    concatenated on hidden layers, averaged on the output layer.
    """
    h = x
    n = len(params["layers"])
    # after the first layer hw has adj.M rows but is gathered by col (range
    # adj.N): on a rectangular adjacency the clipped gather would silently
    # read wrong rows — fail loudly instead (ADVICE r1)
    assert adj.M == adj.N, (
        f"GAT requires a square adjacency, got {(adj.M, adj.N)}")
    row = jnp.clip(adj.row, 0, adj.M - 1)
    col = jnp.clip(adj.col, 0, adj.N - 1)
    for i, layer in enumerate(params["layers"]):
        H, D = layer["a_src"].shape  # head count / per-head dim are static
        hw = (h @ layer["w"]).reshape(-1, H, D)             # (N, H, D)
        alpha_dst = (hw * layer["a_dst"]).sum(-1)           # (N, H)
        alpha_src = (hw * layer["a_src"]).sum(-1)
        logits = alpha_dst[row] + alpha_src[col]            # (E, H)
        logits = jax.nn.leaky_relu(logits, negative_slope)
        att = edge_softmax(adj, logits)                     # (E, H)
        msgs = hw[col] * att[:, :, None]                    # (E, H, D)
        out = jax.ops.segment_sum(msgs, row, num_segments=adj.M,
                                  indices_are_sorted=True)  # (M, H, D)
        if i < n - 1:
            h = jax.nn.elu(out.reshape(-1, H * D))
        else:
            h = out.mean(axis=1)
    return h


# ---------------------------------------------------------------------------
# APPNP (predict-then-propagate)
# ---------------------------------------------------------------------------
def init_appnp(key, in_dim: int, hidden: int, out_dim: int) -> Dict[str, Any]:
    k1, k2 = jax.random.split(key)
    return {"lin1": _dense(k1, in_dim, hidden),
            "lin2": _dense(k2, hidden, out_dim)}


def APPNP(params, adj: PaddedCOO, x: jax.Array, k: int = 10,
          alpha: float = 0.1) -> jax.Array:
    h = jax.nn.relu(x @ params["lin1"]["w"] + params["lin1"]["b"])
    h = h @ params["lin2"]["w"] + params["lin2"]["b"]

    def body(z, _):
        z = (1 - alpha) * adj.spmm(z) + alpha * h
        return z, None

    z, _ = jax.lax.scan(body, h, None, length=k)
    return z
