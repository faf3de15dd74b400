"""Native C++ host-runtime parity tests (runtime/cpp/psp_runtime.cpp)."""
import numpy as np
import pytest

from paddle_sparse_jax import runtime

pytestmark = pytest.mark.skipif(not runtime.available(),
                                reason="native runtime not built")


def test_native_sample_adj_golden():
    """Reference golden case (test_sample.py oracle) through the C ABI."""
    rowptr = np.array([0, 3, 5, 9, 10, 12, 14])
    col = np.array([1, 2, 3, 0, 2, 0, 1, 4, 5, 0, 2, 5, 2, 4])
    r_ptr, r_col, r_eid, r_nid = runtime.sample_adj(
        rowptr, col, np.arange(2, 6), -1, False, 0)
    assert r_nid.tolist() == [2, 3, 4, 5, 0, 1]
    assert r_ptr.tolist() == [0, 4, 5, 7, 9]
    assert r_col.tolist() == [2, 3, 4, 5, 4, 0, 3, 0, 2]
    assert r_eid.tolist() == [7, 8, 5, 6, 9, 10, 11, 12, 13]


def test_native_sample_counts():
    rowptr = np.array([0, 3, 5, 9, 10, 12, 14])
    col = np.array([1, 2, 3, 0, 2, 0, 1, 4, 5, 0, 2, 5, 2, 4])
    r_ptr, r_col, r_eid, r_nid = runtime.sample_adj(
        rowptr, col, np.arange(2, 6), 2, True, 7)
    assert len(r_col) == 8
    r_ptr, r_col, r_eid, r_nid = runtime.sample_adj(
        rowptr, col, np.arange(2, 6), 2, False, 7)
    assert len(r_col) == 7  # node 3 has only one edge
    # distinct within each row
    for i in range(4):
        seg = r_col[r_ptr[i]:r_ptr[i + 1]].tolist()
        assert len(set(seg)) == len(seg)


def test_native_lexsort():
    rng = np.random.default_rng(1)
    row = rng.integers(0, 50, 500)
    col = rng.integers(0, 50, 500)
    perm = runtime.lexsort_rowcol(row, col)
    np.testing.assert_array_equal(np.lexsort((col, row)), perm)


def test_native_rcm_valid_permutation():
    rng = np.random.default_rng(2)
    N = 30
    dense = np.zeros((N, N))
    for i in range(N):
        for j in range(max(0, i - 2), min(N, i + 3)):
            dense[i, j] = 1
    sh = rng.permutation(N)
    dense = dense[np.ix_(sh, sh)]
    indptr = np.concatenate([[0], np.cumsum((dense != 0).sum(1))])
    indices = np.nonzero(dense)[1]
    perm = runtime.rcm(indptr, indices)
    assert sorted(perm.tolist()) == list(range(N))
    re = dense[np.ix_(perm, perm)]
    bw = int(np.abs(np.subtract(*np.nonzero(re))).max())
    assert bw <= 6


def test_native_partition_balanced():
    rng = np.random.default_rng(3)
    N = 64
    dense = (rng.random((N, N)) < 0.1).astype(int)
    np.fill_diagonal(dense, 0)
    indptr = np.concatenate([[0], np.cumsum((dense != 0).sum(1))])
    indices = np.nonzero(dense)[1]
    cluster = runtime.partition_clusters(indptr, indices, 4)
    sizes = np.bincount(cluster, minlength=4)
    assert sizes.sum() == N
    assert sizes.max() <= N // 4 + 2


def test_compat_check():
    from paddle_sparse_jax import runtime
    info = runtime.compat_check()
    assert info["platform"] == "cpu"
    assert info["kernel_route"] == "interpret"
    assert "jax" in info and "jaxlib" in info


def test_deterministic_bitwise():
    """SURVEY.md §5: deterministic mode — two runs of the same jitted
    sparse pipeline must agree bitwise (XLA is deterministic by
    construction; this pins it)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from paddle_sparse_jax.core import PaddedCOO

    rng = np.random.default_rng(9)
    M = N = 128
    nnz = 1000
    row = np.sort(rng.integers(0, M, nnz))
    col = rng.integers(0, N, nnz)
    order = np.lexsort((col, row))
    adj = PaddedCOO.from_arrays(jnp.asarray(row[order], jnp.int32),
                                jnp.asarray(col[order], jnp.int32),
                                jnp.asarray(rng.random(nnz), jnp.float32),
                                (M, N), capacity=1024)
    x = jnp.asarray(rng.standard_normal((N, 32)), jnp.float32)

    @jax.jit
    def step(a, x):
        h = a.spmm(x)
        return jax.grad(lambda v: (a.with_value(v).spmm(x) ** 2).sum())(
            a.value), h

    g1, h1 = step(adj, x)
    g2, h2 = step(adj, x)
    assert np.array_equal(np.asarray(g1), np.asarray(g2))
    assert np.array_equal(np.asarray(h1), np.asarray(h2))
