"""SpMM / SpGEMM benchmark on one GPU.

Times SpMM forward and forward+backward on an ogbn-products-shaped graph
(2,449,029 nodes; 61,859,140 random undirected edges stored both ways,
123,718,280 nnz; generated on the device from ``--seed``) through each
path that can run it:

  kernel    the fused CSR kernel over a cached plan (``spmm_planned``):
            forward kernel; backward one fused kernel pass over A^T
            (transpose SpMM + value gradient)
  traced    the public ``spmm_coo`` under jit with traced indices (the
            GCN path): kernel forward, column sort + fused pass backward
  xla       plain XLA: gather x value + sorted ``segment_sum``; backward
            by autodiff (scatter)
  xla_csc   plain XLA forward; backward as a sorted ``segment_sum`` over
            the planned CSC view plus a chunked SDDMM
  cusparse  ``jax.experimental.sparse`` BCSR with the cuSPARSE lowering
  seg2      ``spmm_seg2`` with one source segment (plain CSR layout)
  seg2_l2   ``spmm_seg2`` with 32 MB source slices (L2-resident gathers)

and, with ``--spgemm``, ``A @ A`` on the 625,000-node degree-16 operand
through ``SparseTensor @ SparseTensor``.

Each number is the median of ``--iters`` calls, each ended by
``block_until_ready``, after a warm-up call whose time (compilation
included) is reported as ``compile_s``.  The card's name and power
limit are printed and recorded beside every number.  A path that fails
is recorded with its error and the run exits non-zero.  A run that finds
no GPU fails.

Usage:
  python bench.py [--k 64,256] [--paths kernel,xla,...] [--iters 5]
                  [--spgemm] [--out chiprun_out/bench.json]
"""
import argparse
import json
import os
import subprocess
import sys
import time

N_NODES = 2_449_029
N_UNDIRECTED = 61_859_140
PATHS = ("kernel", "traced", "xla", "xla_csc", "cusparse", "seg2",
         "seg2_l2")


def card_info() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def products_graph(seed: int, n: int, e: int):
    """Random symmetric graph at ogbn-products' size, (row, col)-sorted,
    built on the device.  Returns ``(row, col, value)`` with values
    uniform in [0, 1)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def gen(key):
        ku, kv, kw = jax.random.split(key, 3)
        u = jax.random.randint(ku, (e,), 0, n, dtype=jnp.int32)
        v = jax.random.randint(kv, (e,), 0, n, dtype=jnp.int32)
        row = jnp.concatenate([u, v])
        col = jnp.concatenate([v, u])
        by_col = jnp.argsort(col, stable=True)
        order = jnp.take(by_col, jnp.argsort(jnp.take(row, by_col),
                                             stable=True))
        value = jax.random.uniform(kw, (2 * e,), jnp.float32)
        return jnp.take(row, order), jnp.take(col, order), value

    return gen(jax.random.PRNGKey(seed))


def _time(fn, args, iters: int):
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return compile_s, times[len(times) // 2] * 1e3, times


def _path_fns(path: str, row, col, n: int, K: int):
    """(setup_s, fwd(state, v, x), state) for one path; ``fwd`` is
    differentiable in (v, x)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from paddle_sparse_jax.ops.kernels.spmm_pallas import sddmm_dot_chunked
    from paddle_sparse_jax.ops.spmm import (make_spmm_plan, spmm_coo,
                                            spmm_planned)
    from paddle_sparse_jax.ops.spmm_seg2 import (make_seg2_plan,
                                                 pack_values, spmm_seg2)

    t0 = time.perf_counter()
    if path == "kernel":
        plan, state = make_spmm_plan(row, col, n, n)

        def fwd(state, v, x):
            return spmm_planned(plan, state, v, x)
    elif path in ("traced", "xla"):
        backend = "pallas" if path == "traced" else "xla"

        def fwd(state, v, x):
            return spmm_coo(state[0], state[1], v, x, n, "sum",
                            backend=backend)
        state = (row, col)
    elif path == "xla_csc":
        _, state = make_spmm_plan(row, col, n, n)

        @jax.custom_vjp
        def fwd(state, v, x):
            return jax.ops.segment_sum(
                jnp.take(x, state.col, axis=0) * v[:, None], state.row,
                num_segments=n, indices_are_sorted=True)

        def seg_fwd(state, v, x):
            return fwd(state, v, x), (state, v, x)

        def seg_bwd(res, g):
            state, v, x = res
            v_t = jnp.take(v, state.perm)
            d_x = jax.ops.segment_sum(
                jnp.take(g, state.col_t, axis=0) * v_t[:, None],
                jnp.take(state.col, state.perm), num_segments=n,
                indices_are_sorted=True)
            d_v = sddmm_dot_chunked(state.row, state.col, g, x)
            zero = jax.tree_util.tree_map(
                lambda a: np.zeros(a.shape, jax.dtypes.float0), state)
            return zero, d_v, d_x

        fwd.defvjp(seg_fwd, seg_bwd)
    elif path == "cusparse":
        from jax.experimental import sparse

        from paddle_sparse_jax.ops.convert import ind2ptr
        jax.config.update("jax_bcoo_cusparse_lowering", True)
        state = (jax.jit(ind2ptr, static_argnums=1)(row, n), col)

        def fwd(state, v, x):
            return sparse.BCSR((v, state[1], state[0]), shape=(n, n)) @ x
    elif path in ("seg2", "seg2_l2"):
        plan, state = make_seg2_plan(
            row, col, n, n, feat_dim=K,
            slice_bytes=(32 << 20) if path == "seg2_l2" else None)

        def fwd(state, v, x):
            return spmm_seg2(plan, state, pack_values(state, v), x)
    else:
        raise ValueError(f"unknown path {path!r}")
    jax.block_until_ready(state)
    return time.perf_counter() - t0, fwd, state


def bench_spmm(paths, ks, iters: int, seed: int, record: dict,
               n: int = N_NODES, e: int = N_UNDIRECTED) -> bool:
    """Fill ``record["spmm"]``; returns True when any path failed."""
    import jax
    import jax.numpy as jnp

    row, col, value = products_graph(seed, n, e)
    jax.block_until_ready(value)
    record["graph"] = {"nodes": n, "nnz": int(row.shape[0]),
                       "undirected_edges": e, "seed": seed}
    failed = False
    for K in ks:
        x = jax.random.normal(jax.random.PRNGKey(seed + K), (n, K),
                              jnp.float32)
        w = jax.random.normal(jax.random.PRNGKey(seed + 2 * K), (n, K),
                              jnp.float32)
        for path in paths:
            key = f"{path}_K{K}"
            try:
                setup_s, fwd, state = _path_fns(path, row, col, n, K)
                f = jax.jit(fwd)

                # every array is an argument: a closed-over array would be
                # compiled in as a constant
                def loss(state, v, xx, w, fwd=fwd):
                    return (fwd(state, v, xx) * w).sum()
                fb = jax.jit(jax.value_and_grad(loss, argnums=(1, 2)))
                c_f, ms_f, t_f = _time(f, (state, value, x), iters)
                c_b, ms_b, t_b = _time(fb, (state, value, x, w), iters)
                record["spmm"][key] = {
                    "setup_s": setup_s, "fwd_ms": ms_f, "fwdbwd_ms": ms_b,
                    "fwd_compile_s": c_f, "fwdbwd_compile_s": c_b,
                    "fwd_all_ms": [t * 1e3 for t in t_f],
                    "fwdbwd_all_ms": [t * 1e3 for t in t_b]}
                del state, f, fb
            except Exception as e:  # noqa: BLE001 - recorded, fails the run
                failed = True
                record["spmm"][key] = {
                    "error": f"{type(e).__name__}: {str(e)[:400]}"}
            print(key, json.dumps(record["spmm"][key])[:300], flush=True)
        del x, w
    return failed


def bench_spgemm(iters: int, seed: int, record: dict):
    import jax
    import jax.numpy as jnp

    from paddle_sparse_jax import SparseTensor
    n, deg = 625_000, 16
    nnz = n * deg
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed + 7))
    row = jnp.arange(nnz, dtype=jnp.int32) // deg
    col = jax.random.randint(k1, (nnz,), 0, n, dtype=jnp.int32)
    val = jax.random.uniform(k2, (nnz,), jnp.float32)
    A = SparseTensor(row=row, col=col, value=val,
                     sparse_sizes=(n, n)).coalesce()
    times = []
    for _ in range(iters + 1):
        t0 = time.perf_counter()
        C = A @ A
        jax.block_until_ready(C.storage.value())
        times.append(time.perf_counter() - t0)
    steady = sorted(times[1:])
    record["spgemm"] = {"a_nnz": int(A.nnz()), "c_nnz": int(C.nnz()),
                        "first_call_s": times[0],
                        "s_per_call": steady[len(steady) // 2],
                        "all_s": times[1:]}
    print("spgemm", json.dumps(record["spgemm"]), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--k", default="64,256")
    ap.add_argument("--paths", default=",".join(PATHS))
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--spgemm", action="store_true")
    ap.add_argument("--no-spmm", action="store_true")
    ap.add_argument("--out", default="chiprun_out/bench.json")
    args = ap.parse_args(argv)

    card = card_info()
    import jax

    from paddle_sparse_jax.cache import enable_compile_cache
    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py measures a GPU; found {dev.platform}",
              file=sys.stderr)
        return 2
    print(card, flush=True)
    record = {"card": card, "device": {"platform": dev.platform,
                                       "kind": dev.device_kind,
                                       "count": len(jax.devices())},
              "spmm": {}}
    failed = False
    if not args.no_spmm:
        failed = bench_spmm([p for p in args.paths.split(",") if p],
                            [int(k) for k in args.k.split(",")],
                            args.iters, args.seed, record)
    if args.spgemm:
        bench_spgemm(args.iters, args.seed, record)
    record["peak_bytes_in_use"] = dev.memory_stats().get(
        "peak_bytes_in_use")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({k: record[k] for k in ("card", "device",
                                             "peak_bytes_in_use")}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
