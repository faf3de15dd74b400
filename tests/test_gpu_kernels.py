"""Card-only checks of the compiled Triton-route kernels (no interpret
mode).  Each test skips without a GPU, decided in the ``gpu`` fixture at
run time; ``chip_smoke.py`` runs this file on the card with
``PSP_TESTS_ON_GPU=1`` (see ``tests/conftest.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_sparse_jax.ops.kernels.spmm_pallas import (csr_spmm,
                                                       csr_spmm_sddmm)

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run on the card by chip_smoke.py")
    return jax.devices()[0]


def _graph(seed, M, N, nnz):
    rng = np.random.default_rng(seed)
    row = np.sort(rng.integers(0, M, nnz))
    row[: nnz // 4] = 3                      # one heavy row
    row = np.sort(row)
    col = rng.integers(0, N, nnz)
    val = rng.standard_normal(nnz).astype(np.float32)
    rowptr = np.searchsorted(row, np.arange(M + 1)).astype(np.int32)
    return row, col.astype(np.int32), val, rowptr


@pytest.mark.parametrize("K", [1, 47, 64, 100, 128, 256, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compiled_kernel_matches_oracle(gpu, K, dtype):
    M, N, nnz = 3000, 2500, 60000
    row, col, val, rowptr = _graph(K, M, N, nnz)
    x = np.random.default_rng(1).standard_normal((N, K)).astype(np.float32)
    v = jnp.asarray(val).astype(dtype)
    xx = jnp.asarray(x).astype(dtype)
    out = jax.jit(lambda a, b, c, d: csr_spmm(a, b, c, d, interpret=False))(
        jnp.asarray(rowptr), jnp.asarray(col), v, xx)
    want = np.zeros((M, K))
    np.add.at(want, row, np.asarray(v, np.float64)[:, None]
              * np.asarray(xx, np.float64)[col])
    # f32 accumulation of exactly-representable products: f32 rounding only
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("K", [16, 100, 256])
def test_compiled_fused_sddmm(gpu, K):
    M, N, nnz = 2000, 1500, 40000
    row, col, val, rowptr = _graph(K + 1, M, N, nnz)
    rng = np.random.default_rng(2)
    g = rng.standard_normal((N, K)).astype(np.float32)
    y = rng.standard_normal((M, K)).astype(np.float32)
    d_x, dv = jax.jit(lambda a, b, c, d, e: csr_spmm_sddmm(
        a, b, c, d, e, interpret=False))(
        jnp.asarray(rowptr), jnp.asarray(col), jnp.asarray(val),
        jnp.asarray(g), jnp.asarray(y))
    want = np.zeros((M, K))
    np.add.at(want, row, val[:, None].astype(np.float64) * g[col])
    np.testing.assert_allclose(np.asarray(d_x), want, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(np.asarray(dv),
                               (g[col].astype(np.float64) * y[row]).sum(1),
                               rtol=1e-4, atol=1e-3)


def test_compiled_identity_stream(gpu):
    M, K, L = 1000, 96, 30000
    rng = np.random.default_rng(3)
    row = np.sort(rng.integers(0, M, L))
    s = rng.standard_normal((L, K)).astype(np.float32)
    rowptr = np.searchsorted(row, np.arange(M + 1)).astype(np.int32)
    out = jax.jit(lambda a, b: csr_spmm(a, None, None, b, interpret=False))(
        jnp.asarray(rowptr), jnp.asarray(s))
    want = np.zeros((M, K))
    np.add.at(want, row, s)
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-4, atol=1e-3)


def test_compiled_traced_vjp(gpu):
    """Public traced path on the card: kernel forward, sort + fused
    backward, against autodiff of the plain XLA formulation."""
    from paddle_sparse_jax.ops.spmm import spmm_coo
    M, N, K, nnz = 4000, 3000, 64, 80000
    row, col, val, _ = _graph(7, M, N, nnz)
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.standard_normal((N, K)), jnp.float32)
    w = jnp.asarray(rng.standard_normal((M, K)), jnp.float32)
    r, c, v = jnp.asarray(row, jnp.int32), jnp.asarray(col), jnp.asarray(val)

    def loss(backend, v, xx, r, c):
        return (spmm_coo(r, c, v, xx, M, "sum", backend=backend) * w).sum()

    with jax.default_matmul_precision("highest"):
        got = jax.jit(jax.grad(lambda *a: loss("pallas", *a),
                               argnums=(0, 1)))(v, x, r, c)
        want = jax.jit(jax.grad(lambda *a: loss("xla", *a),
                                argnums=(0, 1)))(v, x, r, c)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-3)
