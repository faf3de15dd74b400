"""Gradient checks the reference never had (SURVEY.md §4: "add gradient
checks (jax.test_util.check_grads) on value-autograd for spmm/spspmm/
coalesce").  Finite-difference verification of every differentiable surface:
value-autograd through storage canonicalization, SpMM (both operands),
SpGEMM values, reductions, and elementwise sparse ops."""
import jax
import jax.numpy as jnp
import numpy as np
from jax.test_util import check_grads

import paddle_sparse_jax as psp
from paddle_sparse_jax.ops.spmm import spmm_coo
from paddle_sparse_jax.ops.spspmm import spspmm_eager
from paddle_sparse_jax.ops.convert import ind2ptr

rng = np.random.default_rng(17)


def _graph(M, N, nnz, seed=0):
    r = np.random.default_rng(seed)
    row = np.sort(r.integers(0, M, nnz))
    col = r.integers(0, N, nnz)
    order = np.lexsort((col, row))
    row, col = row[order], col[order]
    # coalesce duplicates away so values map 1:1 to structural entries
    keys = row.astype(np.int64) * N + col
    keep = np.concatenate([[True], keys[1:] != keys[:-1]])
    return row[keep], col[keep]


M, N, K = 20, 15, 8
row, col = _graph(M, N, 80)
nnz = row.shape[0]
row_j = jnp.asarray(row, jnp.int32)
col_j = jnp.asarray(col, jnp.int32)
val0 = jnp.asarray(rng.standard_normal(nnz), jnp.float64)
x0 = jnp.asarray(rng.standard_normal((N, K)), jnp.float64)


def test_spmm_sum_grads():
    f = lambda v, x: spmm_coo(row_j, col_j, v, x, M, "sum", backend="xla")
    check_grads(f, (val0, x0), order=1, modes=["rev"], atol=1e-4, rtol=1e-4)


def test_spmm_mean_grads():
    f = lambda v, x: spmm_coo(row_j, col_j, v, x, M, "mean", backend="xla")
    check_grads(f, (val0, x0), order=1, modes=["rev"], atol=1e-4, rtol=1e-4)


def test_spmm_max_grads():
    f = lambda v, x: spmm_coo(row_j, col_j, v, x, M, "max", backend="xla")
    check_grads(f, (val0, x0), order=1, modes=["rev"], atol=1e-4, rtol=1e-4)


def test_spspmm_value_grads():
    rowB, colB = _graph(N, 12, 60, seed=1)
    valB0 = jnp.asarray(rng.standard_normal(rowB.shape[0]), jnp.float64)
    rowptrB = ind2ptr(jnp.asarray(rowB, jnp.int32), N)
    colB_j = jnp.asarray(colB, jnp.int32)

    def f(vA, vB):
        _, _, valC = spspmm_eager(row_j, col_j, vA, rowptrB, colB_j, vB,
                                  M, 12)
        return valC

    check_grads(f, (val0, valB0), order=1, modes=["rev"], atol=1e-4,
                rtol=1e-4)


def test_coalesce_value_grads():
    # duplicate entries: grads must route through the sum-reduction
    r2 = jnp.asarray(np.concatenate([row, row[:10]]), jnp.int32)
    c2 = jnp.asarray(np.concatenate([col, col[:10]]), jnp.int32)
    v2 = jnp.asarray(rng.standard_normal(nnz + 10), jnp.float64)

    def f(v):
        t = psp.SparseTensor(row=r2, col=c2, value=v,
                             sparse_sizes=(M, N)).coalesce("sum")
        return t.storage.value()

    check_grads(f, (v2,), order=1, modes=["rev"], atol=1e-4, rtol=1e-4)


def test_reduce_grads():
    def f(v):
        t = psp.SparseTensor(row=row_j, col=col_j, value=v,
                             sparse_sizes=(M, N))
        return psp.sum(t, dim=1)

    check_grads(f, (val0,), order=1, modes=["rev"], atol=1e-4, rtol=1e-4)


def test_sparse_dense_mul_grads():
    def f(v, d):
        t = psp.SparseTensor(row=row_j, col=col_j, value=v,
                             sparse_sizes=(M, N))
        return psp.mul(t, d).storage.value()

    d0 = jnp.asarray(rng.standard_normal((M, 1)), jnp.float64)
    check_grads(f, (val0, d0), order=1, modes=["rev"], atol=1e-4, rtol=1e-4)


def test_padded_spmm_grads():
    """Grads flow through the padded (jit) representation too."""
    from paddle_sparse_jax.core import PaddedCOO
    adj = PaddedCOO.from_arrays(row_j, col_j, val0, (M, N),
                                capacity=nnz + 13)

    def f(v, x):
        a = PaddedCOO(row=adj.row, col=adj.col,
                      value=jnp.pad(v, (0, 13)), nnz=adj.nnz,
                      shape=adj.shape)
        return a.spmm(x)

    check_grads(f, (val0, x0), order=1, modes=["rev"], atol=1e-4, rtol=1e-4)
