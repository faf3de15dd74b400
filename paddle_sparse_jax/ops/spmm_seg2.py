"""Source-segmented SpMM over a packed value layout.

Edges are bucketed by the *source segment* of their column (``SR``
consecutive rows of the dense operand, a power of two) and sorted by row
within each segment.  The forward runs the fused CSR kernel
(``ops/kernels/spmm_pallas.py``) once per segment, each pass reading x
rows from one ``SR``-row slice only and adding into the running output:

    out = sum_s  kernel(rp_f[s], col_f, vals, x)     # S = ceil(N / SR)

With ``S = 1`` (the default, ``SRC_SLICE_BYTES = None``) this is a plain
CSR SpMM.  A smaller slice keeps each pass's gathered rows resident in
the card's 50 MB L2, at the price of one read-modify-write of the output
per segment; which side wins is a property of the graph and is measured
with the benchmark (see PERF.md).

Values live in the packed (segment, row)-sorted layout (convert once with
:func:`pack_values` — like CSR keeps values in CSR order).  The backward
runs

* ``d_x = A^T @ g`` over the transpose structure (edges bucketed by the
  g-segment of their row, sorted by column) — the same kernel, no scatter;
* ``d_value``: with one transpose segment, in the same pass (the kernel's
  fused per-edge dot reuses the gathered g rows); otherwise a chunked
  SDDMM in packed order.

The reference has no SpMM (unsupported list, /root/reference/README.md:45);
the functional contract implemented here is the upstream one documented
at /root/reference/README.md:267-300 (autograd on values only,
README.md:96).
"""
import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

# source-slice budget (bytes of x rows one segment pass may read); None =
# one segment, i.e. plain CSR.  Chosen by measurement on the card.
SRC_SLICE_BYTES = None


class Seg2Plan(NamedTuple):
    """Static (hashable) geometry for :func:`spmm_seg2`."""
    num_rows: int
    num_cols: int
    S: int             # source segments (forward)
    SR: int            # rows per source segment (power of two)
    S_t: int           # transpose-side segments (source = g)
    SR_t: int
    interpret: bool = False
    stream: str = "f32"


class Seg2Structure(NamedTuple):
    """Device-resident reordered index structure.

    Forward layout: edges sorted by (source segment, row).  Transpose
    layout: edges sorted by (g-segment of ``row``, col).  Passed to jitted
    code as arguments, never as constants of the compiled program."""
    col_f: jax.Array       # (nnz,) cols, fwd layout
    rp_f: jax.Array        # (S, M+1) absolute row pointers per segment
    perm_f: jax.Array      # (nnz,) fwd position -> COO position
    col_t: jax.Array       # (nnz,) g-rows (original rows), t layout
    rp_t: jax.Array        # (S_t, N+1) absolute out-row pointers
    relay_ft: jax.Array    # (nnz,) t position -> fwd position (values)
    row_f: jax.Array       # (nnz,) rows, fwd layout (SDDMM)


def _lg2(v: int) -> int:
    return int(v).bit_length() - 1


def _pick_sr(num_src_rows: int, feat_dim: int, stream_bytes: int,
             slice_bytes: Optional[int] = None) -> int:
    """Rows per source segment: the largest power of two whose slice fits
    ``slice_bytes``, never finer than the (pow2-rounded) source itself;
    one segment when ``slice_bytes`` is None."""
    full = 1 << max(3, (max(1, num_src_rows) - 1).bit_length())
    if slice_bytes is None:
        return full
    sr = 1 << _lg2(max(8, slice_bytes // max(1, feat_dim * stream_bytes)))
    return min(sr, full)


def _counting_order(bucket: jax.Array, S: int):
    """Stable counting sort by a small-range key: returns ``order`` with
    ``order[i]`` the input position of sorted slot ``i``.  ``S`` passes
    of cumsum — no device argsort."""
    nnz = bucket.shape[0]
    counts = jnp.zeros((S,), jnp.int32).at[bucket].add(1)
    wptr = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                            jnp.cumsum(counts).astype(jnp.int32)])

    def body(s_i, rank):
        m = bucket == s_i
        cum = jnp.cumsum(m.astype(jnp.int32))
        return jnp.where(m, cum - 1, rank)

    # fori (not an unrolled python loop): the unrolled form lets XLA keep
    # all S per-pass cumsum buffers live at once
    rank = jax.lax.fori_loop(0, S, body, jnp.zeros((nnz,), jnp.int32))
    pos = jnp.take(wptr, bucket) + rank
    return jnp.zeros((nnz,), jnp.int32).at[pos].set(
        jnp.arange(nnz, dtype=jnp.int32))


def _seg_rowptrs(seg_sorted: jax.Array, row_sorted: jax.Array, S: int,
                 M: int):
    """(S, M+1) absolute row pointers of a (segment, row)-sorted stream,
    via a 2-D count + per-segment cumsum (no composite sort keys — no
    int32 overflow hazard at any M, N)."""
    counts = jnp.zeros((S, M), jnp.int32).at[seg_sorted, row_sorted].add(1)
    within = jnp.concatenate(
        [jnp.zeros((S, 1), jnp.int32),
         jnp.cumsum(counts, axis=1).astype(jnp.int32)], axis=1)
    seg_tot = within[:, -1]
    base = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                            jnp.cumsum(seg_tot).astype(jnp.int32)[:-1]])
    return within + base[:, None]


@functools.partial(jax.jit, static_argnames=("S", "SR", "M"))
def _build_fwd(row, col, *, S, SR, M):
    """Forward layout — stable bucket by x-segment (rows stay sorted
    within each segment because the input is row-sorted).  Module-level
    & shape-polymorphic so the sharded planner can vmap it over a device
    axis."""
    sorted_ok = jnp.all(jnp.diff(row) >= 0) if row.shape[0] else \
        jnp.bool_(True)
    seg = (col >> _lg2(SR)).astype(jnp.int32)
    order_f = _counting_order(seg, S)
    col_f = jnp.take(col, order_f)
    rp_f = _seg_rowptrs(jnp.take(seg, order_f), jnp.take(row, order_f),
                        S, M)
    return order_f, col_f, rp_f, sorted_ok


@functools.partial(jax.jit, static_argnames=("S_t", "SR_t", "N"))
def _build_t(row, col, *, S_t, SR_t, N):
    """Transpose layout — CSC order, then stable bucket by the g-segment
    of the original row."""
    perm_c = jnp.argsort(col, stable=True).astype(jnp.int32)
    rowc = jnp.take(row, perm_c)
    seg_t = (rowc >> _lg2(SR_t)).astype(jnp.int32)
    order_t2 = _counting_order(seg_t, S_t)
    perm_t = jnp.take(perm_c, order_t2)
    col_t = jnp.take(rowc, order_t2)
    xrow_t = jnp.take(jnp.take(col, perm_c), order_t2)
    rp_t = _seg_rowptrs(jnp.take(seg_t, order_t2), xrow_t, S_t, N)
    return perm_t, col_t, rp_t


@jax.jit
def _relays(order_f, perm_t):
    """The value relay fwd -> transpose (t position -> fwd position)."""
    nnz_ = order_f.shape[0]
    ar = jnp.arange(nnz_, dtype=jnp.int32)
    inv_f = jnp.zeros((nnz_,), jnp.int32).at[order_f].set(ar)
    return jnp.take(inv_f, perm_t)


def make_seg2_plan(row, col, num_rows: int, num_cols: int, *,
                   feat_dim: int, stream: Optional[str] = None,
                   sr: Optional[int] = None,
                   slice_bytes: Optional[int] = SRC_SLICE_BYTES):
    """Plan builder (eager; concrete indices).  Returns
    ``(plan, structure)`` for :func:`spmm_seg2`.

    All nnz-sized work runs on the device in a few jitted phases; only
    the sortedness flag reaches the host.

    CONTRACT: ``row`` sorted ascending (canonical COO order).  ``sr``
    overrides the segment size (power of two); ``slice_bytes`` sizes it
    from the bytes of x one pass may read."""
    from .kernels.spmm_pallas import _stream_env, interpret_mode

    stream = stream or _stream_env()
    stream_bytes = 2 if stream == "bf16" else 4

    row = jnp.asarray(row, jnp.int32)
    col = jnp.asarray(col, jnp.int32)
    M, N = num_rows, num_cols

    SR = sr or _pick_sr(N, feat_dim, stream_bytes, slice_bytes)
    assert SR & (SR - 1) == 0, "segment size must be a power of two"
    S = max(1, -(-N // SR))
    SR_t = sr or _pick_sr(M, feat_dim, stream_bytes, slice_bytes)
    S_t = max(1, -(-M // SR_t))

    order_f, col_f, rp_f, sorted_ok = _build_fwd(row, col, S=S, SR=SR, M=M)
    if not bool(sorted_ok):
        raise ValueError(
            "make_seg2_plan requires row indices sorted ascending "
            "(canonical COO order); sort/coalesce the structure first")
    perm_t, col_t, rp_t = _build_t(row, col, S_t=S_t, SR_t=SR_t, N=N)

    plan = Seg2Plan(M, N, S, SR, S_t, SR_t, interpret=interpret_mode(),
                    stream=stream)
    structure = Seg2Structure(
        col_f=col_f, rp_f=rp_f, perm_f=order_f, col_t=col_t, rp_t=rp_t,
        relay_ft=_relays(order_f, perm_t), row_f=jnp.take(row, order_f))
    return plan, structure


@jax.jit
def pack_values(s: Seg2Structure, value: jax.Array) -> jax.Array:
    """COO-ordered (nnz,) values -> the format's fwd layout (one-time
    conversion per operand; the packed vector is the autograd leaf)."""
    return jnp.take(value, s.perm_f)


@jax.jit
def unpack_values(s: Seg2Structure, packed: jax.Array) -> jax.Array:
    """Inverse of :func:`pack_values`."""
    nnz = packed.shape[0]
    return jnp.zeros((nnz,), packed.dtype).at[s.perm_f].set(packed)


def _seg_pass(cols, rp, vals, x, *, S: int, interpret: bool, pdt):
    """Sum of one kernel pass per segment; segment ``s`` covers the edges
    ``rp[s, r] .. rp[s, r+1]`` of every row ``r``."""
    from .kernels.spmm_pallas import csr_spmm

    x = x.astype(pdt)
    vals = None if vals is None else vals.astype(pdt)
    out = csr_spmm(rp[0], cols, vals, x, interpret=interpret)
    if S == 1:
        return out

    def body(s, acc):
        return acc + csr_spmm(rp[s], cols, vals, x, interpret=interpret)

    return jax.lax.fori_loop(1, S, body, out)


def _fwd_impl(plan: Seg2Plan, s: Seg2Structure, packed_value, x):
    from .kernels.spmm_pallas import _product_dtype
    pdt = _product_dtype(packed_value, x, plan.stream)
    return _seg_pass(s.col_f, s.rp_f, packed_value, x, S=plan.S,
                     interpret=plan.interpret, pdt=pdt)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def spmm_seg2(plan: Seg2Plan, s: Seg2Structure,
              packed_value: Optional[jax.Array],
              x: jax.Array) -> jax.Array:
    """``A @ x`` (sum reduction), differentiable in ``(packed_value, x)``.

    ``packed_value``: values in the fwd layout (:func:`pack_values`), or
    ``None`` for structural ones."""
    out = _fwd_impl(plan, s, packed_value, x)
    return out.astype(x.dtype)


def _spmm_seg2_fwd(plan, s, packed_value, x):
    return spmm_seg2(plan, s, packed_value, x), (s, packed_value, x)


def _spmm_seg2_bwd(plan, res, g):
    from .kernels.spmm_pallas import (FUSED_SDDMM_MAX_K, _product_dtype,
                                      csr_spmm_sddmm, sddmm_dot_chunked)
    s, packed_value, x = res
    pdt = _product_dtype(packed_value, g, plan.stream)
    value_t = (None if packed_value is None
               else jnp.take(packed_value, s.relay_ft).astype(pdt))
    d_value = None
    if (packed_value is not None and plan.S_t == 1
            and x.shape[1] <= FUSED_SDDMM_MAX_K):
        # one pass: the value gradient shares the gathered g rows
        d_x, dv_t = csr_spmm_sddmm(s.rp_t[0], s.col_t, value_t,
                                   g.astype(pdt), x.astype(pdt),
                                   interpret=plan.interpret)
        nnz = s.relay_ft.shape[0]
        dv_t = jnp.where(jnp.arange(nnz) < s.rp_t[0, -1], dv_t, 0.0)
        d_value = jnp.zeros((nnz,), jnp.float32).at[s.relay_ft].set(
            dv_t, unique_indices=True).astype(packed_value.dtype)
    else:
        d_x = _seg_pass(s.col_t, s.rp_t, value_t, g, S=plan.S_t,
                        interpret=plan.interpret, pdt=pdt)
        if packed_value is not None:
            d_value = sddmm_dot_chunked(s.row_f, s.col_f, g.astype(pdt),
                                        x.astype(pdt),
                                        out_dtype=packed_value.dtype)
    d_s = jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, jax.dtypes.float0), s)
    return d_s, d_value, d_x.astype(x.dtype)


spmm_seg2.defvjp(_spmm_seg2_fwd, _spmm_seg2_bwd)
