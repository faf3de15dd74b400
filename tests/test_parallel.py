"""Distributed SpMM on a virtual 8-device CPU mesh (SURVEY.md §4: multi-host
tests the reference never had)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from paddle_sparse_jax import SparseTensor
from paddle_sparse_jax.parallel import (make_mesh, shard_padded_coo,
                                        spmm_allgather, spmm_ring)
from paddle_sparse_jax.parallel.spmm import device_put_sharded_matrix

D = 8


@pytest.fixture(scope="module")
def setup():
    if len(jax.devices()) < D:
        pytest.skip(f"needs {D} virtual devices")
    rng = np.random.default_rng(3)
    M = N = 64
    nnz = 512
    row = np.sort(rng.integers(0, M, nnz))
    col = rng.integers(0, N, nnz)
    order = np.lexsort((col, row))
    val = rng.standard_normal(nnz).astype(np.float32)
    adj = SparseTensor(row=jnp.asarray(row[order]),
                       col=jnp.asarray(col[order]),
                       value=jnp.asarray(val[order]), sparse_sizes=(M, N))
    X = rng.standard_normal((N, 16)).astype(np.float32)
    dense = np.asarray(adj.to_dense())
    mesh = make_mesh(D)
    mat = device_put_sharded_matrix(mesh, shard_padded_coo(adj, D))
    x_arr = jax.device_put(jnp.asarray(X), NamedSharding(mesh, P("x", None)))
    return mesh, mat, x_arr, dense @ X


def test_spmm_allgather(setup):
    mesh, mat, x_arr, expected = setup
    out = spmm_allgather(mesh, mat, x_arr)
    np.testing.assert_allclose(np.asarray(out), expected, rtol=1e-4,
                               atol=1e-4)


def test_spmm_ring(setup):
    mesh, mat, x_arr, expected = setup
    out = spmm_ring(mesh, mat, x_arr)
    np.testing.assert_allclose(np.asarray(out), expected, rtol=1e-4,
                               atol=1e-4)


def test_spmm_allgather_grad(setup):
    """Collectives differentiate: grad of sharded SpMM wrt dense operand."""
    mesh, mat, x_arr, expected = setup

    def loss(x):
        return (spmm_allgather(mesh, mat, x) ** 2).sum()

    g = jax.grad(loss)(x_arr)
    # ground truth from autodiff of the equivalent dense computation
    dense_g = np.asarray(
        jax.grad(lambda x: ((jnp.asarray(_dense_of(mat)) @ x) ** 2).sum())(
            jnp.asarray(np.asarray(x_arr))))
    np.testing.assert_allclose(np.asarray(g), dense_g, rtol=1e-3, atol=1e-3)


def _dense_of(mat):
    """Reassemble the dense matrix from a RowShardedMatrix (test helper)."""
    D_, C = mat.row.shape
    M, N = mat.shape
    out = np.zeros((M, N), np.float32)
    rows = np.asarray(mat.row)
    cols = np.asarray(mat.col)
    vals = np.asarray(mat.value)
    for d in range(D_):
        for k in range(C):
            r, c = rows[d, k], cols[d, k]
            if r < mat.rows_per_shard and c < N:
                out[d * mat.rows_per_shard + r, c] += vals[d, k]
    return out


def test_graft_dryrun():
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", os.path.join(os.path.dirname(__file__), "..",
                                        "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, args = mod.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (256, 8)
    mod.dryrun_multichip(8)


def test_spgemm_rowsharded():
    """Row-sharded distributed SpGEMM == dense A @ B on an 8-dev mesh."""
    from paddle_sparse_jax.core import PaddedCOO
    from paddle_sparse_jax.parallel import (device_put_blocks, gather_blocks,
                                            make_mesh, shard_padded_rows,
                                            spgemm_rowsharded)

    if len(jax.devices()) < D:
        pytest.skip(f"needs {D} virtual devices")
    rng = np.random.default_rng(11)
    M, K, N, nnzA, nnzB = 64, 48, 40, 400, 300
    rowA = np.sort(rng.integers(0, M, nnzA))
    colA = rng.integers(0, K, nnzA)
    valA = rng.standard_normal(nnzA).astype(np.float32)
    rowB = np.sort(rng.integers(0, K, nnzB))
    colB = rng.integers(0, N, nnzB)
    valB = rng.standard_normal(nnzB).astype(np.float32)

    A = SparseTensor(row=jnp.asarray(rowA), col=jnp.asarray(colA),
                     value=jnp.asarray(valA), sparse_sizes=(M, K)).coalesce()
    B = SparseTensor(row=jnp.asarray(rowB), col=jnp.asarray(colB),
                     value=jnp.asarray(valB), sparse_sizes=(K, N)).coalesce()
    expected = np.asarray(A.to_dense()) @ np.asarray(B.to_dense())

    mesh = make_mesh(D)
    A_blocks, rows_per = shard_padded_rows(A, D)
    A_blocks = device_put_blocks(mesh, A_blocks)
    B_pad = B.to_padded()
    B_pad = jax.device_put(B_pad, NamedSharding(mesh, P()))

    from paddle_sparse_jax.ops.spspmm import plan_spgemm
    flop_cap, out_cap = plan_spgemm(A.to_padded(), B_pad)
    C_blocks, overflowed = spgemm_rowsharded(mesh, A_blocks, B_pad,
                                             flop_capacity=flop_cap,
                                             out_capacity=out_cap)
    assert not bool(np.asarray(overflowed).any())
    rowC, colC, valC = gather_blocks(C_blocks, rows_per, M, N)
    got = np.zeros((M, N), np.float32)
    np.add.at(got, (np.asarray(rowC), np.asarray(colC)), np.asarray(valC))
    np.testing.assert_allclose(got, expected, rtol=1e-4, atol=1e-4)


def test_spmm_ring_bucketed(setup):
    """Pre-bucketed ring == dense (VERDICT r1 #5: O(nnz/D) per step)."""
    from paddle_sparse_jax.parallel import (device_put_ring,
                                            shard_ring_buckets,
                                            spmm_ring_bucketed)
    mesh, mat, x_arr, expected = setup
    adj = _tensor_of(mat)
    rmat = device_put_ring(mesh, shard_ring_buckets(adj, D))
    out = spmm_ring_bucketed(mesh, rmat, x_arr)
    np.testing.assert_allclose(np.asarray(out), expected, rtol=1e-4,
                               atol=1e-4)


def test_spmm_halo(setup):
    """all_to_all halo exchange == dense (SURVEY §2.4 large-N strategy)."""
    from paddle_sparse_jax.parallel import (device_put_halo, shard_halo,
                                            spmm_halo)
    mesh, mat, x_arr, expected = setup
    adj = _tensor_of(mat)
    hmat = device_put_halo(mesh, shard_halo(adj, D))
    # halo exchanges strictly fewer rows than all-gather replicates
    assert hmat.halo_per_src <= mat.shape[1] // D
    out = spmm_halo(mesh, hmat, x_arr)
    np.testing.assert_allclose(np.asarray(out), expected, rtol=1e-4,
                               atol=1e-4)


def test_spmm_halo_grad(setup):
    from paddle_sparse_jax.parallel import (device_put_halo, shard_halo,
                                            spmm_halo)
    mesh, mat, x_arr, expected = setup
    adj = _tensor_of(mat)
    hmat = device_put_halo(mesh, shard_halo(adj, D))

    def loss(x):
        return (spmm_halo(mesh, hmat, x) ** 2).sum()

    g = jax.grad(loss)(x_arr)
    dense_g = np.asarray(
        jax.grad(lambda x: ((jnp.asarray(_dense_of(mat)) @ x) ** 2).sum())(
            jnp.asarray(np.asarray(x_arr))))
    np.testing.assert_allclose(np.asarray(g), dense_g, rtol=1e-3,
                               atol=1e-3)


def test_spmm_2d(setup):
    """2-D grid + psum_scatter == dense (SURVEY §2.4 'sparse TP' row)."""
    from paddle_sparse_jax.parallel import device_put_2d, shard_2d, spmm_2d
    from paddle_sparse_jax.parallel.spmm2d import make_mesh_2d
    mesh, mat, x_arr, expected = setup
    adj = _tensor_of(mat)
    dr, dc = 2, 4
    mesh2 = make_mesh_2d(dr, dc)
    m2 = device_put_2d(mesh2, shard_2d(adj, dr, dc))
    N, K = mat.shape[1], np.asarray(x_arr).shape[-1]
    xb = jnp.asarray(np.asarray(x_arr)).reshape(N, K)
    from jax.sharding import NamedSharding, PartitionSpec as P2
    xb = jax.device_put(xb, NamedSharding(mesh2, P2("dc", None)))
    out = spmm_2d(mesh2, m2, xb)
    np.testing.assert_allclose(np.asarray(out), expected, rtol=1e-4,
                               atol=1e-4)


def test_scaling_estimates():
    """Analytic scaling model: sane efficiencies + the SURVEY §2.4
    crossover (halo beats all-gather when N is huge and edges are few)."""
    from paddle_sparse_jax.parallel import estimate_scaling
    from paddle_sparse_jax.parallel.scaling import scaling_report

    # ogbn-products, dim 256, 8 cards, an illustrative achieved bandwidth
    kind = "NVIDIA H100 80GB HBM3"
    rep = scaling_report(8, 124_000_000, 2_449_029, 2_449_029, 256,
                         achieved_gbps=280.0, device_kind=kind)
    for s, r in rep.items():
        if not isinstance(r, dict):     # scalar metadata (target_gbps)
            continue
        assert 0 < r["efficiency"] <= 1.0, (s, r)
        assert 0 < r["efficiency_at_target"] <= 1.0, (s, r)
    # at this shape every strategy should scale well (compute-dominated)
    assert rep["ring"]["efficiency"] >= 0.8
    assert rep["halo"]["efficiency"] >= 0.8
    # the at-target column must DISCRIMINATE at pod scale: all-gather's
    # replicated exchange cannot hold 80% at D=256 where 2-D can
    pod = scaling_report(256, 124_000_000, 2_449_029, 2_449_029, 256,
                         achieved_gbps=280.0, device_kind=kind)
    assert pod["all_gather"]["efficiency_at_target"] < 0.5
    assert pod["2d"]["efficiency_at_target"] > \
        pod["all_gather"]["efficiency_at_target"]

    # papers100M-like: N huge, all-gather must fall off a cliff vs halo
    big = {"nnz": 1_600_000_000, "m": 111_000_000, "n": 111_000_000,
           "k": 128}
    # at a card-class achieved bandwidth the exchange, not compute, binds
    ag = estimate_scaling("all_gather", 16, achieved_gbps=2000.0,
                          device_kind=kind, **big)
    halo = estimate_scaling("halo", 16, achieved_gbps=2000.0,
                            device_kind=kind, **big,
                            unique_cols=big["nnz"] // 16)
    assert halo.efficiency > ag.efficiency


def _tensor_of(mat):
    """RowShardedMatrix -> eager SparseTensor (test helper)."""
    dense = _dense_of(mat)
    return SparseTensor.from_dense(jnp.asarray(dense))


def test_spmm_seg2_sharded_flagship():
    """The FLAGSHIP (seg2 planned Pallas path) runs under shard_map with
    host-built per-shard plans (VERDICT r3 item 2) — forward and grads
    match the dense oracle."""
    if len(jax.devices()) < D:
        pytest.skip(f"needs {D} virtual devices")
    from paddle_sparse_jax.parallel.spmm_seg2 import (
        device_put_sharded_seg2, make_seg2_plan_sharded,
        pack_values_sharded, spmm_seg2_allgather)

    rng = np.random.default_rng(11)
    M = N = 128
    K, nnz = 128, 900
    row = np.sort(rng.integers(0, M, nnz))
    col = rng.integers(0, N, nnz)
    order = np.lexsort((col, row))
    val = rng.standard_normal(nnz).astype(np.float32)
    adj = SparseTensor(row=jnp.asarray(row[order]),
                       col=jnp.asarray(col[order]),
                       value=jnp.asarray(val[order]), sparse_sizes=(M, N))
    X = rng.standard_normal((N, K)).astype(np.float32)
    dense = np.asarray(adj.to_dense())

    mesh = make_mesh(D)
    mat = device_put_sharded_matrix(mesh, shard_padded_coo(adj, D))
    sh = make_seg2_plan_sharded(mat, feat_dim=K, sr=32)
    assert sh.plan.S > 1            # multi-segment geometry exercised
    sh = device_put_sharded_seg2(mesh, sh)
    packed = pack_values_sharded(sh, mat.value)
    x_arr = jax.device_put(jnp.asarray(X),
                           NamedSharding(mesh, P("x", None)))

    out = spmm_seg2_allgather(mesh, sh, packed, x_arr)
    got = np.asarray(out).reshape(M, K)
    np.testing.assert_allclose(got, dense @ X, rtol=1e-4, atol=1e-4)

    # gradients flow through the collective + the seg2 custom VJP
    def loss(pv, x):
        o = spmm_seg2_allgather(mesh, sh, pv, x)
        return (o.reshape(M, K) ** 2).sum()

    d_pv, d_x = jax.grad(loss, argnums=(0, 1))(packed, x_arr)
    g = 2.0 * (dense @ X)
    want_dx = dense.T @ g
    np.testing.assert_allclose(np.asarray(d_x), want_dx, rtol=1e-3,
                               atol=1e-3)
    # d_value: dv[e] = g[row].x[col]; map through the per-shard packing
    rows_l = np.asarray(mat.row)
    cols_l = np.asarray(mat.col)
    perm = np.asarray(sh.structure.perm_f)
    rows_per = mat.rows_per_shard
    want_dpv = np.zeros_like(np.asarray(packed))
    for d in range(D):
        pr = rows_l[d][perm[d]]
        pc = cols_l[d][perm[d]]
        valid = (pr < rows_per) & (pc < N)
        gr = g[np.clip(pr + d * rows_per, 0, M - 1)]
        xc = X[np.clip(pc, 0, N - 1)]
        want_dpv[d] = np.where(valid, (gr * xc).sum(axis=1), 0.0)
    np.testing.assert_allclose(np.asarray(d_pv), want_dpv, rtol=1e-3,
                               atol=1e-3)


def test_spmm_seg2_halo():
    """seg2 x halo interchange (VERDICT r4 item 5): the planned Pallas
    flagship under the deduplicated all_to_all halo exchange — forward
    and both gradients match the dense oracle."""
    if len(jax.devices()) < D:
        pytest.skip(f"needs {D} virtual devices")
    from paddle_sparse_jax.parallel.spmm import shard_halo
    from paddle_sparse_jax.parallel.spmm_seg2 import (
        device_put_sharded_seg2, make_seg2_halo_plan,
        pack_values_sharded, spmm_seg2_halo)

    rng = np.random.default_rng(13)
    M = N = 128
    K, nnz = 64, 700
    row = np.sort(rng.integers(0, M, nnz))
    col = rng.integers(0, N, nnz)
    order = np.lexsort((col, row))
    val = rng.standard_normal(nnz).astype(np.float32)
    adj = SparseTensor(row=jnp.asarray(row[order]),
                       col=jnp.asarray(col[order]),
                       value=jnp.asarray(val[order]),
                       sparse_sizes=(M, N)).coalesce()
    dense = np.asarray(adj.to_dense())
    X = rng.standard_normal((N, K)).astype(np.float32)

    mesh = make_mesh(D)
    halo = shard_halo(adj, D)
    sh = make_seg2_halo_plan(halo, feat_dim=K, sr=32)
    assert sh.plan.num_cols == D * halo.halo_per_src
    sh = device_put_sharded_seg2(mesh, sh)
    packed = pack_values_sharded(sh, halo.value)
    x_arr = jax.device_put(jnp.asarray(X),
                           NamedSharding(mesh, P("x", None)))

    out = spmm_seg2_halo(mesh, halo, sh, packed, x_arr)
    got = np.asarray(out).reshape(M, K)
    np.testing.assert_allclose(got, dense @ X, rtol=1e-4, atol=1e-4)

    def loss(pv, x):
        o = spmm_seg2_halo(mesh, halo, sh, pv, x)
        return (o.reshape(M, K) ** 2).sum()

    d_pv, d_x = jax.grad(loss, argnums=(0, 1))(packed, x_arr)
    g = 2.0 * (dense @ X)
    np.testing.assert_allclose(np.asarray(d_x), dense.T @ g, rtol=1e-3,
                               atol=1e-3)
    # d_value through halo-buffer col remapping + per-shard packing
    rows_l = np.asarray(halo.row)
    hcols_l = np.asarray(halo.col)
    send = np.asarray(halo.send_idx)
    H = halo.halo_per_src
    perm = np.asarray(sh.structure.perm_f)
    rows_per = halo.rows_per_shard
    blk = N // D
    want_dpv = np.zeros_like(np.asarray(packed))
    for d in range(D):
        pr = rows_l[d][perm[d]]
        ph = hcols_l[d][perm[d]]
        src = ph // H
        # halo slot -> global x row: send_idx[src, d, pos] + src*blk
        gcol = send[src, d, ph - src * H] + src * blk
        valid = pr < rows_per
        gr = g[np.clip(pr + d * rows_per, 0, M - 1)]
        xc = X[gcol]
        want_dpv[d] = np.where(valid, (gr * xc).sum(axis=1), 0.0)
    np.testing.assert_allclose(np.asarray(d_pv), want_dpv, rtol=1e-3,
                               atol=1e-3)
