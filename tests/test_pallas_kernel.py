"""Fused CSR SpMM kernel (Triton route) correctness, in Pallas interpret
mode on the CPU; the compiled kernel is checked on the card by
``tests/test_gpu_kernels.py`` through ``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_sparse_jax.ops.kernels.spmm_pallas import (csr_spmm,
                                                       interpret_mode,
                                                       segment_rows_matmul,
                                                       spmm_pallas)

rng = np.random.default_rng(5)


def _graph(M, N, nnz):
    row = np.sort(rng.integers(0, M, nnz))
    col = rng.integers(0, N, nnz)
    order = np.lexsort((col, row))
    row, col = row[order], col[order]
    rowptr = np.searchsorted(row, np.arange(M + 1))
    return row, col, rowptr


def _oracle(row, col, val, x, M):
    out = np.zeros((M, x.shape[1]), np.float64)
    w = np.ones(len(row)) if val is None else np.asarray(val, np.float64)
    np.add.at(out, row, w[:, None] * np.asarray(x, np.float64)[col])
    return out


@pytest.mark.parametrize("K", [64, 128, 256])
def test_spmm_pallas_interpret(K):
    M, N, nnz = 300, 200, 4000
    row, col, rowptr = _graph(M, N, nnz)
    val = rng.standard_normal(nnz).astype(np.float32)
    x = rng.standard_normal((N, K)).astype(np.float32)

    out = spmm_pallas(jnp.asarray(rowptr, jnp.int32),
                      jnp.asarray(col, jnp.int32), jnp.asarray(val),
                      jnp.asarray(x), interpret=True)
    np.testing.assert_allclose(np.asarray(out), _oracle(row, col, val, x, M),
                               rtol=1e-4, atol=1e-4)


def test_spmm_pallas_bf16_interpret():
    """bf16 streams are read as bf16; accumulation is f32 so results match
    the f64 oracle on the bf16-rounded inputs."""
    M, N, K, nnz = 300, 200, 128, 4000
    row, col, rowptr = _graph(M, N, nnz)
    val16 = jnp.asarray(rng.standard_normal(nnz)).astype(jnp.bfloat16)
    x16 = jnp.asarray(rng.standard_normal((N, K))).astype(jnp.bfloat16)

    out = spmm_pallas(jnp.asarray(rowptr, jnp.int32),
                      jnp.asarray(col, jnp.int32), val16, x16,
                      interpret=True)
    # uniform contract: output follows the promoted input dtype
    assert out.dtype == jnp.bfloat16
    want = _oracle(row, col, np.asarray(val16, np.float64),
                   np.asarray(x16, np.float64), M)
    # the output itself is rounded to bf16 (8 mantissa bits)
    np.testing.assert_allclose(np.asarray(out, np.float64), want,
                               rtol=1e-2, atol=2e-2)


def test_segment_rows_matmul_empty_rows():
    """Rows with no edges and ragged tails must come out zero."""
    M, K = 260, 64
    row = np.asarray([0, 0, 5, 259])
    products = np.ones((4, K), np.float32)
    rowptr = np.searchsorted(row, np.arange(M + 1))
    out = segment_rows_matmul(jnp.asarray(products),
                              jnp.asarray(row, jnp.int32),
                              jnp.asarray(rowptr, jnp.int32), M,
                              interpret=True)
    out_np = np.asarray(out)
    assert out_np[0, 0] == 2.0
    assert out_np[5, 0] == 1.0
    assert out_np[259, 0] == 1.0
    mask = np.ones(M, bool)
    mask[[0, 5, 259]] = False
    assert np.abs(out_np[mask]).max() == 0.0


def test_spmm_backend_pallas_grads_interpret():
    """backend="pallas" on the CPU runs the kernel in interpret mode; its
    gradients must match the XLA formulation's autodiff."""
    M, N, K, nnz = 40, 30, 64, 300
    row, col, rowptr = _graph(M, N, nnz)
    val = jnp.asarray(rng.standard_normal(nnz), jnp.float32)
    x = jnp.asarray(rng.standard_normal((N, K)), jnp.float32)
    rowj = jnp.asarray(row, jnp.int32)
    colj = jnp.asarray(col, jnp.int32)
    from paddle_sparse_jax.ops import spmm as smod

    def loss_p(v, xx):
        return (smod.spmm_coo(rowj, colj, v, xx, M, "sum",
                              backend="pallas") ** 2).sum()

    def loss_x(v, xx):
        return (smod.spmm_coo(rowj, colj, v, xx, M, "sum",
                              backend="xla") ** 2).sum()

    gp = jax.grad(loss_p, argnums=(0, 1))(val, x)
    gx = jax.grad(loss_x, argnums=(0, 1))(val, x)
    np.testing.assert_allclose(np.asarray(gp[0]), np.asarray(gx[0]),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(gp[1]), np.asarray(gx[1]),
                               rtol=1e-3, atol=1e-4)


def test_spmm_csr_chunked_matches_reference():
    """Planned SpMM with rows split into many pseudo-rows (the hot-row
    split, forced here by a tiny cap) == dense oracle."""
    import paddle_sparse_jax.ops.spmm as spmm_mod
    M, N, K, nnz = 700, 500, 64, 9000
    row, col, rowptr = _graph(M, N, nnz)
    val = rng.standard_normal(nnz).astype(np.float32)
    x = rng.standard_normal((N, K)).astype(np.float32)
    plan, s = spmm_mod.make_spmm_plan(
        jnp.asarray(row, jnp.int32), jnp.asarray(col, jnp.int32), M, N,
        row_split=4)
    assert plan.num_pseudo > M and plan.num_pseudo_t > N
    out = spmm_mod.spmm_planned(plan, s, jnp.asarray(val), jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(out), _oracle(row, col, val, x, M),
                               rtol=1e-4, atol=1e-4)


def test_spmm_chunked_vjp_grads():
    """Planned custom VJP (CSC kernel backward + chunked SDDMM) == XLA
    autodiff."""
    import paddle_sparse_jax.ops.spmm as spmm_mod
    M, N, K, nnz = 260, 180, 64, 3000
    row, col, rowptr = _graph(M, N, nnz)
    val = rng.standard_normal(nnz).astype(np.float32)
    x = rng.standard_normal((N, K)).astype(np.float32)
    row_j, col_j = jnp.asarray(row, jnp.int32), jnp.asarray(col, jnp.int32)
    val_j, x_j = jnp.asarray(val), jnp.asarray(x)

    w = jnp.asarray(rng.standard_normal(K).astype(np.float32))

    plan, structure = spmm_mod.make_spmm_plan(row_j, col_j, M, N)

    def loss_planned(v, xx):
        return (spmm_mod.spmm_planned(plan, structure, v, xx) * w).sum()

    def loss_ref(v, xx):
        return (spmm_mod.spmm_coo(row_j, col_j, v, xx, M, "sum",
                                  backend="xla") * w).sum()

    g1 = jax.grad(loss_planned, argnums=(0, 1))(val_j, x_j)
    g2 = jax.grad(loss_ref, argnums=(0, 1))(val_j, x_j)
    np.testing.assert_allclose(np.asarray(g1[0]), np.asarray(g2[0]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(g1[1]), np.asarray(g2[1]),
                               rtol=1e-4, atol=1e-4)


def test_spmm_chunked_as_jit_args():
    """Structure arrays passed as jit ARGUMENTS (not closures, so large
    index arrays never become compiled constants)."""
    import paddle_sparse_jax.ops.spmm as spmm_mod
    M, N, K, nnz = 300, 260, 64, 2500
    row, col, rowptr = _graph(M, N, nnz)
    val = rng.standard_normal(nnz).astype(np.float32)
    x = rng.standard_normal((N, K)).astype(np.float32)
    plan, structure = spmm_mod.make_spmm_plan(
        jnp.asarray(row, jnp.int32), jnp.asarray(col, jnp.int32), M, N)

    @jax.jit
    def fwd(structure, value, x):
        return spmm_mod.spmm_planned(plan, structure, value, x)

    @jax.jit
    def fwd_bwd(structure, value, x):
        def loss(v, xx):
            return spmm_mod.spmm_planned(plan, structure, v, xx).sum()
        return jax.value_and_grad(loss, argnums=(0, 1))(value, x)

    out = fwd(structure, jnp.asarray(val), jnp.asarray(x))
    expected = _oracle(row, col, val, x, M)
    np.testing.assert_allclose(np.asarray(out), expected, rtol=1e-4,
                               atol=1e-4)
    loss, (dv, dx) = fwd_bwd(structure, jnp.asarray(val), jnp.asarray(x))
    np.testing.assert_allclose(float(loss), expected.sum(), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(dv), x[col].sum(1), rtol=1e-4,
                               atol=1e-4)


def test_bf16_stream_optin(monkeypatch):
    """PSP_SPMM_STREAM=bf16 halves the gathered bytes at ~3 decimal digits
    of element precision; accumulation stays f32 (strict f32 default)."""
    # The env knob is snapshotted ONCE at import (jit caches are not keyed
    # on the environment); per-call choice goes through the explicit
    # ``stream`` argument / SpmmPlan.stream instead.
    from paddle_sparse_jax.ops.kernels.spmm_pallas import _product_dtype
    val = jnp.ones((4,), jnp.float32)
    x32 = jnp.ones((4, 8), jnp.float32)
    assert _product_dtype(val, x32, stream="bf16") == jnp.bfloat16
    assert _product_dtype(val, x32, stream="f32") == jnp.float32
    # mid-process env flips do NOT change behavior (import-time snapshot)
    monkeypatch.setenv("PSP_SPMM_STREAM", "bf16")
    assert _product_dtype(val, x32) == jnp.float32
    # f64 never drops precision regardless of the knob
    assert _product_dtype(val.astype(jnp.float64),
                          x32.astype(jnp.float64),
                          stream="bf16") == jnp.float32

    M, N, K, nnz = 120, 100, 64, 900
    row, col, rowptr = _graph(M, N, nnz)
    v = rng.standard_normal(nnz).astype(np.float32)
    x = rng.standard_normal((N, K)).astype(np.float32)
    out = spmm_pallas(jnp.asarray(rowptr, jnp.int32),
                      jnp.asarray(col, jnp.int32), jnp.asarray(v),
                      jnp.asarray(x), interpret=True, stream="bf16")
    expected = _oracle(row, col, v, x, M)
    # bf16 elements carry ~8 bits of mantissa: bound the error relative
    # to the largest output magnitude, not element-wise
    err = np.abs(np.asarray(out) - expected).max()
    assert err <= 2e-2 * np.abs(expected).max(), err
    # and it IS bf16-rounded (differs from the strict-f32 path)
    out32 = spmm_pallas(jnp.asarray(rowptr, jnp.int32),
                        jnp.asarray(col, jnp.int32), jnp.asarray(v),
                        jnp.asarray(x), interpret=True, stream="f32")
    assert np.abs(np.asarray(out32) - expected).max() < err


def test_fused_backward_multiblock():
    """Planned backward with pseudo-rows on BOTH sides (forward rows and
    CSC columns split) must match the oracle gradients."""
    import paddle_sparse_jax.ops.spmm as spmm_mod
    M, N, K, nnz = 520, 410, 64, 4200
    row, col, rowptr = _graph(M, N, nnz)
    val = rng.standard_normal(nnz).astype(np.float32)
    x = rng.standard_normal((N, K)).astype(np.float32)
    g = rng.standard_normal((M, K)).astype(np.float32)
    plan, s = spmm_mod.make_spmm_plan(
        jnp.asarray(row, jnp.int32), jnp.asarray(col, jnp.int32), M, N,
        row_split=3)
    assert plan.num_pseudo > M and plan.num_pseudo_t > N

    def loss(v, xx):
        return (spmm_mod.spmm_planned(plan, s, v, xx) * g).sum()

    dv, dx = jax.grad(loss, argnums=(0, 1))(jnp.asarray(val),
                                            jnp.asarray(x))
    want_dv = (g[row] * x[col]).sum(axis=1)
    want_dx = np.zeros((N, K), np.float32)
    np.add.at(want_dx, col, val[:, None] * g[row])
    np.testing.assert_allclose(np.asarray(dv), want_dv, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(dx), want_dx, rtol=1e-4,
                               atol=1e-4)


def test_long_row_splitting_powerlaw():
    """Rows longer than the split cap are cut into pseudo-rows and folded
    back — results and gradients must match the XLA path on a graph with
    one dominating row."""
    import paddle_sparse_jax.ops.spmm as spmm_mod
    M, N, K = 300, 280, 64
    hot = rng.integers(0, N, 5000)             # row 0 owns 5000 edges
    rest_r = np.sort(rng.integers(1, M, 2000))
    rest_c = rng.integers(0, N, 2000)
    row = np.concatenate([np.zeros(5000, np.int64), rest_r])
    col = np.concatenate([hot, rest_c])
    order = np.lexsort((col, row))
    row, col = row[order].astype(np.int32), col[order].astype(np.int32)
    nnz = row.shape[0]
    val = rng.standard_normal(nnz).astype(np.float32)
    x = rng.standard_normal((N, K)).astype(np.float32)

    plan, s = spmm_mod.make_spmm_plan(jnp.asarray(row), jnp.asarray(col),
                                      M, N, row_split=2048)
    # the hot row must actually have been split
    assert plan.num_pseudo > M

    w = jnp.asarray(rng.standard_normal((M, K)).astype(np.float32))

    def loss_planned(v, xx):
        return (spmm_mod.spmm_planned(plan, s, v, xx) * w).sum()

    def loss_ref(v, xx):
        return (spmm_mod.spmm_coo(jnp.asarray(row), jnp.asarray(col), v,
                                  xx, num_rows=M, reduce="sum",
                                  backend="xla") * w).sum()

    l1, g1 = jax.value_and_grad(loss_planned, argnums=(0, 1))(
        jnp.asarray(val), jnp.asarray(x))
    l2, g2 = jax.value_and_grad(loss_ref, argnums=(0, 1))(
        jnp.asarray(val), jnp.asarray(x))
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(g1[0]), np.asarray(g2[0]),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(g1[1]), np.asarray(g2[1]),
                               rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# the kernel itself: widths, structural edge cases, gradient rule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("K", [1, 8, 47, 64, 100, 128, 256])
def test_csr_kernel_widths(K):
    """Every width, including K below the 16-lane tile minimum and K that
    is not a multiple of the K tile (masked lanes)."""
    M, N, nnz = 90, 70, 700
    row, col, rowptr = _graph(M, N, nnz)
    val = rng.standard_normal(nnz).astype(np.float32)
    x = rng.standard_normal((N, K)).astype(np.float32)
    out = csr_spmm(jnp.asarray(rowptr, jnp.int32),
                   jnp.asarray(col, jnp.int32), jnp.asarray(val),
                   jnp.asarray(x), interpret=True)
    assert out.shape == (M, K) and out.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(out), _oracle(row, col, val, x, M),
                               rtol=1e-5, atol=1e-5)


def _case(name):
    """(row, col, val, x, M, N) for one structural edge case."""
    M, N, K = 64, 48, 32
    x = rng.standard_normal((N, K)).astype(np.float32)
    if name == "empty_rows":            # most rows empty, incl. first/last
        row = np.asarray([3, 3, 17, 40, 40, 40])
    elif name == "heavy_row":           # one row far longer than a chunk
        row = np.sort(np.concatenate([np.full(900, 7),
                                      rng.integers(0, M, 100)]))
    elif name == "padding_rows":        # padded COO: dead row M-1, col N
        row = np.concatenate([np.sort(rng.integers(0, M - 1, 200)),
                              np.full(30, M - 1)])
    else:                               # uniform
        row = np.sort(rng.integers(0, M, 400))
    col = rng.integers(0, N, row.shape[0])
    val = rng.standard_normal(row.shape[0]).astype(np.float32)
    if name == "padding_rows":
        col[-30:] = N                   # one past the end, value 0
        val[-30:] = 0.0
    return row, col, val, x, M, N


@pytest.mark.parametrize("name", ["empty_rows", "heavy_row",
                                  "padding_rows"])
def test_csr_kernel_structure(name):
    row, col, val, x, M, N = _case(name)
    rowptr = np.searchsorted(row, np.arange(M + 1))
    out = csr_spmm(jnp.asarray(rowptr, jnp.int32),
                   jnp.asarray(col, jnp.int32), jnp.asarray(val),
                   jnp.asarray(x), interpret=True)
    want = _oracle(row, np.minimum(col, N - 1), val, x, M)
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-5, atol=1e-5)


def test_csr_kernel_no_value():
    row, col, _, x, M, N = _case("uniform")
    rowptr = np.searchsorted(row, np.arange(M + 1))
    out = csr_spmm(jnp.asarray(rowptr, jnp.int32),
                   jnp.asarray(col, jnp.int32), None, jnp.asarray(x),
                   interpret=True)
    np.testing.assert_allclose(np.asarray(out),
                               _oracle(row, col, None, x, M),
                               rtol=1e-5, atol=1e-5)


def test_csr_kernel_bf16_stream():
    """bf16 operands: products in f32 after the load, f32 accumulation —
    exact against the oracle on the bf16-rounded inputs up to f32 sums."""
    row, col, val, x, M, N = _case("uniform")
    rowptr = np.searchsorted(row, np.arange(M + 1))
    v16 = jnp.asarray(val).astype(jnp.bfloat16)
    x16 = jnp.asarray(x).astype(jnp.bfloat16)
    out = csr_spmm(jnp.asarray(rowptr, jnp.int32),
                   jnp.asarray(col, jnp.int32), v16, x16, interpret=True)
    assert out.dtype == jnp.float32
    want = _oracle(row, col, np.asarray(v16, np.float64),
                   np.asarray(x16, np.float64), M)
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-5, atol=1e-5)


def test_csr_kernel_identity_cols():
    """``col=None`` reduces a materialised stream: edge e reads x[e]."""
    M, K, L = 50, 24, 333
    row = np.sort(rng.integers(0, M, L))
    stream = rng.standard_normal((L, K)).astype(np.float32)
    rowptr = np.searchsorted(row, np.arange(M + 1))
    out = csr_spmm(jnp.asarray(rowptr, jnp.int32), None, None,
                   jnp.asarray(stream), interpret=True)
    want = np.zeros((M, K))
    np.add.at(want, row, stream)
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_value", [True, False])
def test_csr_kernel_traced_vjp(with_value):
    """The traced-index custom VJP (column sort + kernel over A^T, chunked
    SDDMM) against ``jax.grad`` of the plain reference, under jit."""
    from paddle_sparse_jax.ops import spmm as smod
    M, N, K, nnz = 70, 55, 48, 800
    row, col, _ = _graph(M, N, nnz)
    rowj, colj = jnp.asarray(row, jnp.int32), jnp.asarray(col, jnp.int32)
    val = jnp.asarray(rng.standard_normal(nnz), jnp.float32)
    x = jnp.asarray(rng.standard_normal((N, K)), jnp.float32)
    w = jnp.asarray(rng.standard_normal((M, K)), jnp.float32)

    def loss(backend, r, c, v, xx):
        vv = v if with_value else None
        return (smod.spmm_coo(r, c, vv, xx, M, "sum", backend=backend)
                * w).sum()

    got = jax.jit(jax.grad(lambda r, c, v, xx: loss("pallas", r, c, v, xx),
                           argnums=(2, 3)))(rowj, colj, val, x)
    want = jax.grad(lambda v, xx: loss("xla", rowj, colj, v, xx),
                    argnums=(0, 1))(val, x)
    if with_value:
        np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("platform,expected", [
    ("cpu", True), ("gpu", False), ("cuda", False), ("rocm", None),
    ("metal", None)])
def test_device_rule(platform, expected):
    """The CPU interprets, the GPU compiles, any other platform raises."""
    if expected is None:
        with pytest.raises(NotImplementedError, match="no Pallas kernel"):
            interpret_mode(platform)
    else:
        assert interpret_mode(platform) is expected


def test_device_rule_follows_default_device():
    """A ``jax.default_device(cpu)`` context selects interpret mode."""
    with jax.default_device(jax.devices("cpu")[0]):
        assert interpret_mode() is True
