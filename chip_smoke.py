"""Smoke test of the system on the GPU: the quickest proof that it starts.

    python chip_smoke.py            # one card, every phase below
    python chip_smoke.py --multi    # four cards: the sharded paths only

Phases (one card):

0. card tests — ``tests/test_gpu_kernels.py`` (marker ``gpu``) in a child
   process, before this process touches the card;
1. kernels — each Triton-route kernel compiled at real widths
   (K in 64/128/256, f32 and bf16 streams) and compared with the plain
   reference under ``jax.default_matmul_precision("highest")``;
2. main path, full width — an ogbn-products-shaped graph made from
   ``--seed`` (2,449,029 nodes, 61,859,140 undirected edges stored both
   ways: 123,718,280 nnz; 100 input features, 47 classes): a few training
   steps of the 2-layer GCN (hidden 256) through ``PaddedCOO.spmm``, an
   eager ``SparseTensor @ X``, and the planned seg2 SpMM forward+backward
   at K=256, checked against a float64 host reference (scipy CSR) on a
   seeded sample of rows, columns and edges;
3. SpGEMM — ``A @ A`` on a 625,000-node degree-16 operand through
   ``SparseTensor @ SparseTensor``, checked against scipy on sampled rows;
4. sampling — 3-hop ``sample_adj`` (fanouts 15/10/5, 1,024 seeds) on the
   phase-2 graph, checked for its structural invariants.

``--multi`` (four cards, a 1-D mesh over NVLink) runs only the sharded
paths on the phase-2 graph split four ways — the seg2 all-gather and halo
GCN train steps, the all-gather / ring / bucketed-ring / halo / 2-D
interchanges — and the row-sharded SpGEMM on the phase-3 operand, each
compared with the single-card result.

Every phase prints its compile and steady-state times, peak device
memory and each comparison with its tolerance.  Tolerances: f32 results
agree with the reference to ~1e-4 relative (f32 accumulation order);
bf16 streams to ~1e-2 (their products are rounded to 8 mantissa bits).
The card's name and power limit (``nvidia-smi``) are printed on the line
before the last, which is one JSON object; any failed phase, or a run
without a GPU, exits non-zero without it.
"""
import argparse
import json
import os
import subprocess
import sys
import time

F32_RTOL = 1e-4
BF16_RTOL = 1e-2


class Config:
    """Sizes of every phase; the defaults are the full-width run."""
    nodes = 2_449_029
    undirected = 61_859_140
    features = 100
    hidden = 256
    classes = 47
    gcn_steps = 3
    kernel_nodes = 400_000
    kernel_deg = 50
    spgemm_nodes = 625_000
    spgemm_deg = 16
    seeds = 1024
    fanouts = (15, 10, 5)
    sample = 512          # rows / columns / edges checked on the host


def log(msg):
    print(msg, flush=True)


def card_info():
    """``name, power.limit`` of every card, or None without nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


def _peak():
    import jax
    return max((d.memory_stats() or {}).get("peak_bytes_in_use", 0)
               for d in jax.local_devices())


def _timed(fn, *args, iters=3):
    """(compile+first call seconds, median steady seconds, last result)."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return first, sorted(times)[len(times) // 2], out


def _rel_err(got, want):
    import numpy as np
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got - want).max()) / scale


def jit_over(fn, tup):
    """``jax.jit`` of ``fn(tup, *args)`` with the array fields of the
    NamedTuple ``tup`` passed as arguments (a closed-over array would be
    compiled in as a constant); its other fields stay static."""
    import jax
    arrays = {k: v for k, v in tup._asdict().items()
              if isinstance(v, jax.Array)}
    f = jax.jit(lambda arrs, *a: fn(tup._replace(**arrs), *a))
    return lambda *a: f(arrays, *a)


def check(name, err, tol):
    ok = bool(err <= tol)
    log(f"  check {name}: rel_err={err:.3e} tol={tol:.0e} "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"{name}: rel_err {err:.3e} > {tol:.0e}")


def products_graph(cfg, seed):
    """Random symmetric (row, col)-sorted graph of ``cfg.nodes`` nodes and
    ``cfg.undirected`` edges stored both ways, with unit-interval values,
    built on the device (bench.py's generator)."""
    import bench
    return bench.products_graph(seed, cfg.nodes, cfg.undirected)


# ---------------------------------------------------------------------------
# phase 0: card-only tests, in a child process (this one stays off the card)
# ---------------------------------------------------------------------------
def phase_card_tests():
    t0 = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu",
         "-p", "no:cacheprovider", os.path.join("tests",
                                                "test_gpu_kernels.py")],
        cwd=here, env=dict(os.environ, PSP_TESTS_ON_GPU="1"),
        capture_output=True, text=True, timeout=900)
    tail = proc.stdout.strip().splitlines()[-1:] or [""]
    log(f"  card tests: rc={proc.returncode} {tail[0]} "
        f"({time.perf_counter() - t0:.1f} s)")
    if proc.returncode != 0 or " skipped" in tail[0]:
        log(proc.stdout[-4000:] + proc.stderr[-2000:])
        raise AssertionError("card-only tests failed or skipped")


# ---------------------------------------------------------------------------
# phase 1: the kernels at real widths
# ---------------------------------------------------------------------------
def phase_kernels(cfg, seed):
    import jax
    import jax.numpy as jnp

    from paddle_sparse_jax.ops.kernels.spmm_pallas import (csr_spmm,
                                                           csr_spmm_sddmm)
    n, deg = cfg.kernel_nodes, cfg.kernel_deg
    L = n * deg
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed + 1))
    col = jax.random.randint(k1, (L,), 0, n, dtype=jnp.int32)
    val = jax.random.uniform(k2, (L,), jnp.float32)
    row = jnp.arange(L, dtype=jnp.int32) // deg
    rowptr = jnp.arange(n + 1, dtype=jnp.int32) * deg

    @jax.jit
    def ref(col, row, v, x):
        with jax.default_matmul_precision("highest"):
            return jax.ops.segment_sum(jnp.take(x, col, axis=0)
                                       * v[:, None], row, num_segments=n,
                                       indices_are_sorted=True)

    @jax.jit
    def ref_dv(col, row, x, y):
        return (jnp.take(x, col, axis=0)
                * jnp.take(y, row, axis=0)).sum(axis=1)

    kern = jax.jit(lambda rp, c, v, x: csr_spmm(rp, c, v, x))
    fused = jax.jit(lambda rp, c, v, g, y: csr_spmm_sddmm(rp, c, v, g, y))
    for K in (64, 128, 256):
        x = jax.random.normal(jax.random.PRNGKey(seed + K), (n, K))
        want = ref(col, row, val, x)
        for dt, tol in ((jnp.float32, F32_RTOL), (jnp.bfloat16, BF16_RTOL)):
            first, steady, got = _timed(kern, rowptr, col, val.astype(dt),
                                        x.astype(dt))
            log(f"  csr_spmm K={K} {jnp.dtype(dt).name}: compile+first "
                f"{first:.2f} s, steady {steady * 1e3:.3f} ms")
            check(f"csr_spmm K={K} {jnp.dtype(dt).name}",
                  _rel_err(got, want), tol)
        # fused transpose + SDDMM pass (the backward's kernel)
        y = jax.random.normal(jax.random.PRNGKey(seed + 3 * K), (n, K))
        first, steady, (d_x, dv) = _timed(fused, rowptr, col, val, x, y)
        log(f"  csr_spmm_sddmm K={K} f32: compile+first {first:.2f} s, "
            f"steady {steady * 1e3:.3f} ms")
        check(f"csr_spmm_sddmm d_x K={K}", _rel_err(d_x, want), F32_RTOL)
        dv_want = ref_dv(col, row, x, y)
        check(f"csr_spmm_sddmm dv K={K}", _rel_err(dv, dv_want), F32_RTOL)
        del x, y, want, d_x, dv, dv_want
    log(f"  peak_bytes_in_use {_peak()}")


# ---------------------------------------------------------------------------
# phase 2: the main path at full width
# ---------------------------------------------------------------------------
class HostRef:
    """float64 host reference over scipy CSR/CSC views of the graph."""

    def __init__(self, row, col, val, n):
        import numpy as np
        import scipy.sparse as sp
        self.row = np.asarray(row)
        self.col = np.asarray(col)
        self.val = np.asarray(val, np.float64)
        self.n = n
        rowptr = np.searchsorted(self.row, np.arange(n + 1))
        self.csr = sp.csr_matrix((self.val, self.col, rowptr), shape=(n, n))
        self.csc = self.csr.tocsc()

    def rows(self, rows, x):
        """(A @ x)[rows] from the device array ``x``, gathering only the
        x rows the sampled rows touch."""
        import jax.numpy as jnp
        import numpy as np
        sub = self.csr[rows]
        cols = np.unique(sub.indices)
        xs = np.asarray(jnp.take(x, jnp.asarray(cols), axis=0), np.float64)
        return sub[:, cols] @ xs

    def cols(self, cols, g):
        """(A^T @ g)[cols]."""
        import jax.numpy as jnp
        import numpy as np
        sub = self.csc[:, cols].T.tocsr()
        rows = np.unique(sub.indices)
        gs = np.asarray(jnp.take(g, jnp.asarray(rows), axis=0), np.float64)
        return sub[:, rows] @ gs

    def edges(self, eids, g, x):
        """g[row[e]] . x[col[e]] for sampled COO edges."""
        import jax.numpy as jnp
        import numpy as np
        gr = np.asarray(jnp.take(g, jnp.asarray(self.row[eids]), axis=0),
                        np.float64)
        xc = np.asarray(jnp.take(x, jnp.asarray(self.col[eids]), axis=0),
                        np.float64)
        return (gr * xc).sum(axis=1)


def phase_main(cfg, seed, graph):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from paddle_sparse_jax import SparseTensor
    from paddle_sparse_jax.core import PaddedCOO
    from paddle_sparse_jax.models import GCN, gcn_normalize, init_gcn
    from paddle_sparse_jax.ops.spmm_seg2 import (make_seg2_plan,
                                                 pack_values, spmm_seg2)
    row, col, val = graph
    n = cfg.nodes
    nnz = int(row.shape[0])
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    host = HostRef(row, col, val, n)
    log(f"  graph: {n} nodes, {nnz} nnz; host reference built in "
        f"{time.perf_counter() - t0:.1f} s")
    sample_rows = np.sort(rng.choice(n, cfg.sample, replace=False))
    sample_edges = np.sort(rng.choice(nnz, cfg.sample, replace=False))

    # --- GCN training steps through PaddedCOO.spmm (traced indices) -----
    kx, ky, kp = jax.random.split(jax.random.PRNGKey(seed + 11), 3)
    feats = jax.random.normal(kx, (n, cfg.features), jnp.float32)
    labels = jax.random.randint(ky, (n,), 0, cfg.classes)
    params = init_gcn(kp, cfg.features, cfg.hidden, cfg.classes)
    adj = gcn_normalize(PaddedCOO.from_arrays(row, col, val, (n, n)))

    @jax.jit
    def train_step(params, adj, feats, labels):
        def loss_fn(p):
            logp = jax.nn.log_softmax(GCN(p, adj, feats), axis=-1)
            return -jnp.take_along_axis(logp, labels[:, None], 1).mean()
        loss, grads = jax.value_and_grad(loss_fn)(params)
        return jax.tree_util.tree_map(lambda a, b: a - 0.1 * b, params,
                                      grads), loss

    losses, times = [], []
    for step in range(cfg.gcn_steps):
        t0 = time.perf_counter()
        params, loss = train_step(params, adj, feats, labels)
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
    log(f"  gcn: losses {[round(v, 6) for v in losses]}; compile+first "
        f"{times[0]:.2f} s, steady {min(times[1:] or times) * 1e3:.1f} ms"
        f"/step")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"GCN loss not finite: {losses}")
    del adj, params

    # --- eager SparseTensor @ X (concrete indices: planned kernel path) --
    A = SparseTensor(row=row, col=col, value=val, sparse_sizes=(n, n),
                     is_sorted=True)
    t0 = time.perf_counter()
    out = jax.block_until_ready(A @ feats)
    log(f"  SparseTensor @ X (K={cfg.features}): first call incl. plan "
        f"{time.perf_counter() - t0:.2f} s")
    with jax.default_matmul_precision("highest"):
        check("SparseTensor @ X rows",
              _rel_err(np.asarray(jnp.take(out, jnp.asarray(sample_rows),
                                           axis=0)),
                       host.rows(sample_rows, feats)), F32_RTOL)
    del A, out, feats

    # --- planned seg2 SpMM forward + backward at K=256 ------------------
    K = cfg.hidden
    x = jax.random.normal(jax.random.PRNGKey(seed + 12), (n, K))
    w = jax.random.normal(jax.random.PRNGKey(seed + 13), (n, K))
    t0 = time.perf_counter()
    plan, s = make_seg2_plan(row, col, n, n, feat_dim=K)
    packed = jax.block_until_ready(pack_values(s, val))
    log(f"  seg2 plan (S={plan.S}, S_t={plan.S_t}): "
        f"{time.perf_counter() - t0:.2f} s")

    def loss(s, pv, x, w):
        return (spmm_seg2(plan, s, pv, x) * w).sum()

    fwd = jax.jit(lambda s, pv, x: spmm_seg2(plan, s, pv, x))
    fb = jax.jit(jax.value_and_grad(loss, argnums=(1, 2)))
    first, steady, out = _timed(fwd, s, packed, x)
    log(f"  seg2 fwd K={K}: compile+first {first:.2f} s, steady "
        f"{steady * 1e3:.2f} ms")
    first_b, steady_b, (_, (d_pv, d_x)) = _timed(fb, s, packed, x, w)
    log(f"  seg2 fwd+bwd K={K}: compile+first {first_b:.2f} s, steady "
        f"{steady_b * 1e3:.2f} ms")
    from paddle_sparse_jax.ops.spmm_seg2 import unpack_values
    d_val = unpack_values(s, d_pv)
    check("seg2 forward rows",
          _rel_err(np.asarray(jnp.take(out, jnp.asarray(sample_rows), 0)),
                   host.rows(sample_rows, x)), F32_RTOL)
    check("seg2 d_x columns",
          _rel_err(np.asarray(jnp.take(d_x, jnp.asarray(sample_rows), 0)),
                   host.cols(sample_rows, w)), F32_RTOL)
    check("seg2 d_value edges",
          _rel_err(np.asarray(jnp.take(d_val, jnp.asarray(sample_edges))),
                   host.edges(sample_edges, w, x)), F32_RTOL)
    log(f"  peak_bytes_in_use {_peak()}")
    return host


# ---------------------------------------------------------------------------
# phase 3: SpGEMM
# ---------------------------------------------------------------------------
def spgemm_operand(cfg, seed):
    import jax
    import jax.numpy as jnp
    n, deg = cfg.spgemm_nodes, cfg.spgemm_deg
    nnz = n * deg
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed + 21))
    row = jnp.arange(nnz, dtype=jnp.int32) // deg
    col = jax.random.randint(k1, (nnz,), 0, n, dtype=jnp.int32)
    val = jax.random.uniform(k2, (nnz,), jnp.float32)
    return row, col, val


def phase_spgemm(cfg, seed):
    import jax
    import numpy as np
    import scipy.sparse as sp

    from paddle_sparse_jax import SparseTensor
    n = cfg.spgemm_nodes
    row, col, val = spgemm_operand(cfg, seed)
    A = SparseTensor(row=row, col=col, value=val,
                     sparse_sizes=(n, n)).coalesce()
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        C = A @ A
        jax.block_until_ready(C.storage.value())
        times.append(time.perf_counter() - t0)
    log(f"  A @ A: A nnz {int(A.nnz())}, C nnz {int(C.nnz())}; first "
        f"{times[0]:.2f} s, second {times[1]:.2f} s")
    rp, cc, vv = (np.asarray(a) for a in A.csr())
    Ah = sp.csr_matrix((vv.astype(np.float64), cc, rp), shape=(n, n))
    rows = np.sort(np.random.default_rng(seed).choice(n, cfg.sample,
                                                      replace=False))
    want = (Ah[rows] @ Ah).tocsr()
    want.sort_indices()
    crp, ccol, cval = (np.asarray(a) for a in C.csr())
    got_col = [ccol[crp[r]:crp[r + 1]] for r in rows]
    got_val = np.concatenate([cval[crp[r]:crp[r + 1]] for r in rows])
    same = all(np.array_equal(g, want.indices[want.indptr[i]:
                                              want.indptr[i + 1]])
               for i, g in enumerate(got_col))
    log(f"  check A @ A sampled row structure: "
        f"{'ok' if same else 'FAILED'}")
    if not same:
        raise AssertionError("A @ A sparsity pattern differs from scipy")
    check("A @ A sampled row values", _rel_err(got_val, want.data),
          F32_RTOL)
    log(f"  peak_bytes_in_use {_peak()}")


# ---------------------------------------------------------------------------
# phase 4: neighbour sampling
# ---------------------------------------------------------------------------
def phase_sampling(cfg, seed, host):
    import numpy as np

    from paddle_sparse_jax import SparseTensor, sample_adj
    n = cfg.nodes
    A = SparseTensor(row=host.row, col=host.col, sparse_sizes=(n, n),
                     is_sorted=True)
    keys = host.row.astype(np.int64) * n + host.col
    deg = np.diff(host.csr.indptr)
    subset = np.sort(np.random.default_rng(seed).choice(n, cfg.seeds,
                                                        replace=False))
    t0 = time.perf_counter()
    for hop, fanout in enumerate(cfg.fanouts):
        adj, n_id = sample_adj(A, subset, fanout)
        n_id = np.asarray(n_id)
        rowptr, colx, _ = (np.asarray(a) if a is not None else None
                           for a in adj.csr())
        counts = np.diff(rowptr)
        src = np.repeat(subset, counts)
        dst = n_id[colx]
        ok = (tuple(adj.sparse_sizes()) == (len(subset), len(n_id))
              and np.array_equal(n_id[:len(subset)], subset)
              and np.array_equal(counts, np.minimum(deg[subset], fanout))
              and len(np.unique(n_id)) == len(n_id))
        pos = np.searchsorted(keys, src.astype(np.int64) * n + dst)
        ok = ok and bool(np.all(keys[np.minimum(pos, len(keys) - 1)]
                                == src.astype(np.int64) * n + dst))
        log(f"  hop {hop + 1} (fanout {fanout}): {len(subset)} rows -> "
            f"{len(n_id)} nodes, {int(counts.sum())} edges; invariants "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"sample_adj hop {hop + 1} invariants")
        subset = n_id
    log(f"  3-hop sampling: {time.perf_counter() - t0:.2f} s")


def _seg2_gcn_step(mesh, sh, src, halo, n, ce, head):
    """Jitted GCN loss+grads through the sharded seg2 path; every array
    (structure, packed values, halo send indices) is an argument."""
    import jax

    from paddle_sparse_jax.parallel.spmm_seg2 import (spmm_seg2_allgather,
                                                      spmm_seg2_halo)

    @jax.jit
    def step(params, x, struct, packed, labels, send_idx):
        shs = sh._replace(structure=struct)

        def sp(h):
            if halo:
                out = spmm_seg2_halo(mesh, src._replace(send_idx=send_idx),
                                     shs, packed, h)
            else:
                out = spmm_seg2_allgather(mesh, shs, packed, h)
            return out.reshape(n, -1)

        def lf(p):
            h = jax.nn.relu(sp(x) @ p["layers"][0]["w"]
                            + p["layers"][0]["b"])
            return ce(head(sp(h), p["layers"][1]), labels)
        return jax.value_and_grad(lf)(params)

    return step


# ---------------------------------------------------------------------------
# --multi: the sharded paths on four cards
# ---------------------------------------------------------------------------
def phase_multi(cfg, seed, n_dev=4):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from paddle_sparse_jax import SparseTensor
    from paddle_sparse_jax.core import PaddedCOO
    from paddle_sparse_jax.models import GCN, gcn_normalize, init_gcn
    from paddle_sparse_jax.ops.spmm import spmm_coo
    from paddle_sparse_jax.parallel import (
        device_put_2d, device_put_blocks, device_put_halo, device_put_ring,
        gather_blocks, make_mesh, shard_2d, shard_halo, shard_padded_coo,
        shard_padded_rows, shard_ring_buckets, spgemm_rowsharded, spmm_2d,
        spmm_allgather, spmm_halo, spmm_ring, spmm_ring_bucketed)
    from paddle_sparse_jax.parallel.spmm import device_put_sharded_matrix
    from paddle_sparse_jax.parallel.spmm2d import make_mesh_2d
    from paddle_sparse_jax.parallel.spmm_seg2 import (
        device_put_sharded_seg2, make_seg2_halo_plan, make_seg2_plan_sharded,
        pack_values_sharded)
    from paddle_sparse_jax.ops.spspmm import plan_spgemm

    mesh = make_mesh(n_dev)
    n = cfg.nodes - cfg.nodes % (2 * n_dev)      # rows split evenly
    row, col, val = products_graph(cfg, seed)
    keep = (row < n) & (col < n)
    row, col, val = (np.asarray(a)[np.asarray(keep)] for a in (row, col,
                                                               val))
    log(f"  graph: {n} nodes, {len(row)} nnz over {n_dev} cards")
    # GCN-normalized once; every sharded path below runs on these values
    padded = gcn_normalize(PaddedCOO.from_arrays(
        jnp.asarray(row), jnp.asarray(col), jnp.asarray(val), (n, n)))
    adj = SparseTensor(row=jnp.asarray(row), col=jnp.asarray(col),
                       value=padded.value[:len(row)], sparse_sizes=(n, n),
                       is_sorted=True)
    x = jax.random.normal(jax.random.PRNGKey(seed + 31), (n, cfg.features))
    # jitted: op by op, XLA would materialise the nnz x K product stream
    ref = jax.jit(lambda r, c, v, x: spmm_coo(r, c, v, x, n, "sum",
                                              backend="xla"))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(ref(adj.storage.row(), adj.storage.col(),
                              adj.storage.value(), x))
    x_sh = jax.device_put(x, NamedSharding(mesh, P("x", None)))

    def timed_check(name, fn, *args):
        first, steady, out = _timed(fn, *args, iters=2)
        log(f"  {name}: compile+first {first:.2f} s, steady "
            f"{steady * 1e3:.2f} ms")
        check(name, _rel_err(np.asarray(out).reshape(n, -1), want),
              F32_RTOL)

    t0 = time.perf_counter()
    mat = device_put_sharded_matrix(mesh, shard_padded_coo(adj, n_dev))
    log(f"  row shards: {time.perf_counter() - t0:.1f} s")
    timed_check("all-gather SpMM", jit_over(
        lambda m, x: spmm_allgather(mesh, m, x), mat), x_sh)
    timed_check("ring SpMM", jit_over(
        lambda m, x: spmm_ring(mesh, m, x), mat), x_sh)
    t0 = time.perf_counter()
    rmat = device_put_ring(mesh, shard_ring_buckets(adj, n_dev))
    log(f"  ring buckets: {time.perf_counter() - t0:.1f} s")
    timed_check("bucketed-ring SpMM", jit_over(
        lambda m, x: spmm_ring_bucketed(mesh, m, x), rmat), x_sh)
    del rmat
    t0 = time.perf_counter()
    hmat = device_put_halo(mesh, shard_halo(adj, n_dev))
    log(f"  halo plan: {time.perf_counter() - t0:.1f} s")
    timed_check("halo SpMM", jit_over(
        lambda m, x: spmm_halo(mesh, m, x), hmat), x_sh)
    dr, dc = 2, n_dev // 2
    mesh2 = make_mesh_2d(dr, dc)
    t0 = time.perf_counter()
    m2 = device_put_2d(mesh2, shard_2d(adj, dr, dc))
    log(f"  2-D blocks: {time.perf_counter() - t0:.1f} s")
    x2 = jax.device_put(x, NamedSharding(mesh2, P("dc", None)))
    timed_check(f"2-D SpMM ({dr}x{dc})", jit_over(
        lambda m, x: spmm_2d(mesh2, m, x), m2), x2)
    del m2, x2

    # --- sharded GCN train steps through seg2 (all-gather and halo) ----
    labels = jax.random.randint(jax.random.PRNGKey(seed + 32), (n,), 0,
                                cfg.classes)
    params = init_gcn(jax.random.PRNGKey(seed + 33), cfg.features,
                      cfg.hidden, cfg.classes)

    def head(h, p):
        return jax.nn.log_softmax(h @ p["w"] + p["b"], axis=-1)

    def ce(logp, labels):
        return -jnp.take_along_axis(logp, labels[:, None], 1).mean()

    @jax.jit
    def single_step(params, padded, x, labels):
        def lf(p):
            return ce(jax.nn.log_softmax(GCN(p, padded, x), axis=-1),
                      labels)
        return jax.value_and_grad(lf)(params)

    loss_1, grads_1 = single_step(params, padded, x, labels)
    params_r = jax.device_put(params, NamedSharding(mesh, P()))
    for name, src in (("seg2 all-gather", mat), ("seg2 halo", hmat)):
        t0 = time.perf_counter()
        if name == "seg2 halo":
            sh = make_seg2_halo_plan(src, feat_dim=cfg.hidden)
        else:
            sh = make_seg2_plan_sharded(src, feat_dim=cfg.hidden)
        sh = device_put_sharded_seg2(mesh, sh)
        packed = pack_values_sharded(sh, src.value)
        log(f"  {name} plan: {time.perf_counter() - t0:.1f} s")

        step = _seg2_gcn_step(mesh, sh, src, name == "seg2 halo", n, ce,
                              head)
        first, steady, (loss_d, grads_d) = _timed(
            step, params_r, x_sh, sh.structure, packed, labels,
            hmat.send_idx, iters=2)
        log(f"  {name} GCN train step: compile+first {first:.2f} s, "
            f"steady {steady * 1e3:.1f} ms, loss {float(loss_d):.6f}")
        check(f"{name} GCN loss", _rel_err(loss_d, loss_1), F32_RTOL)
        gd = jax.tree_util.tree_leaves(grads_d)
        g1 = jax.tree_util.tree_leaves(grads_1)
        check(f"{name} GCN grads",
              max(_rel_err(a, b) for a, b in zip(gd, g1)), 1e-3)
        del sh, packed
    del hmat, mat

    # --- row-sharded SpGEMM on the phase-3 operand ----------------------
    ns = cfg.spgemm_nodes - cfg.spgemm_nodes % n_dev
    r3, c3, v3 = (np.asarray(a) for a in spgemm_operand(cfg, seed))
    keep = (r3 < ns) & (c3 < ns)
    A = SparseTensor(row=jnp.asarray(r3[keep]), col=jnp.asarray(c3[keep]),
                     value=jnp.asarray(v3[keep]),
                     sparse_sizes=(ns, ns)).coalesce()
    t0 = time.perf_counter()
    blocks, rows_per = shard_padded_rows(A, n_dev)
    blocks = device_put_blocks(mesh, blocks)
    B = jax.device_put(A.to_padded(), NamedSharding(mesh, P()))
    flop_cap, out_cap = plan_spgemm(A.to_padded(), B, exact_out=False)
    log(f"  SpGEMM shards + plan: {time.perf_counter() - t0:.1f} s")
    first, steady, (C_blocks, over) = _timed(
        jax.jit(lambda a, b: spgemm_rowsharded(
            mesh, a, b, flop_capacity=flop_cap, out_capacity=out_cap)),
        blocks, B, iters=1)
    log(f"  row-sharded A @ A: compile+first {first:.2f} s, steady "
        f"{steady:.3f} s")
    if bool(np.asarray(over).any()):
        raise AssertionError("row-sharded SpGEMM overflowed its capacity")
    rowC, colC, valC = (np.asarray(a) for a in gather_blocks(
        C_blocks, rows_per, ns, ns))
    C1 = A @ A
    crp, ccol, cval = (np.asarray(a) for a in C1.csr())
    order = np.lexsort((colC, rowC))
    same = (len(rowC) == len(ccol)
            and np.array_equal(colC[order], ccol)
            and np.array_equal(np.searchsorted(rowC[order],
                                               np.arange(ns + 1)), crp))
    log(f"  check row-sharded A @ A structure vs one card: "
        f"{'ok' if same else 'FAILED'}")
    if not same:
        raise AssertionError("row-sharded SpGEMM pattern differs")
    check("row-sharded A @ A values", _rel_err(valC[order], cval),
          F32_RTOL)
    log(f"  peak_bytes_in_use (max over cards) {_peak()}")


def main(argv=None):
    ap = argparse.ArgumentParser(description="GPU smoke test")
    ap.add_argument("--multi", action="store_true",
                    help="four cards: run the sharded paths only")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    card = card_info()
    if not card:
        print("chip_smoke: no GPU (nvidia-smi found no card)",
              file=sys.stderr)
        return 2
    try:
        import paddle_sparse_jax  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the package is not importable: {e}",
              file=sys.stderr)
        return 2
    cfg = Config()
    n_dev = 4 if args.multi else 1
    if not args.multi:
        log("phase 0: card-only tests")
        try:
            phase_card_tests()
        except Exception as e:  # noqa: BLE001 - reported, fails the run
            print(f"chip_smoke: phase 0 failed: {e}", file=sys.stderr)
            return 1

    import jax

    from paddle_sparse_jax.cache import enable_compile_cache
    enable_compile_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < n_dev:
        print(f"chip_smoke: need {n_dev} GPU(s), JAX found "
              f"{len(devs)} {devs[0].platform} device(s)", file=sys.stderr)
        return 2

    if args.multi:
        phases = [("multi: sharded paths on four cards",
                   lambda: phase_multi(cfg, args.seed, n_dev))]
    else:
        state = {}
        phases = [
            ("phase 1: kernels", lambda: phase_kernels(cfg, args.seed)),
            ("phase 2: main path, full width",
             lambda: state.update(host=phase_main(
                 cfg, args.seed, products_graph(cfg, args.seed)))),
            ("phase 3: SpGEMM", lambda: phase_spgemm(cfg, args.seed)),
            ("phase 4: sampling",
             lambda: phase_sampling(cfg, args.seed, state["host"])),
        ]
    t_all = time.perf_counter()
    for name, fn in phases:
        log(name)
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:  # noqa: BLE001 - reported, fails the run
            import traceback
            traceback.print_exc()
            print(f"chip_smoke: {name} failed: {type(e).__name__}: {e}",
                  file=sys.stderr)
            return 1
        log(f"  {name} done in {time.perf_counter() - t0:.1f} s")
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
