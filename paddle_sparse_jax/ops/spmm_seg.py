"""Source-blocked SpMM: edges grouped by (row block, source segment).

Partition the dense operand's rows into segments of ``SEG_ROWS``;
reorder the edge stream once per structure so each row-block's edges are
grouped by source segment (sorted by row within a group); the forward
loops row blocks (``lax.map``) and, per block, statically unrolls the
segments — gathering each group from its ``dynamic_slice`` segment,
scaling by the value window, and reducing with the fused kernel's
materialised-stream mode (``kernels/spmm_pallas.py``).  Per-segment
partials sum into the block output.  This layout was built for a gather
engine whose rate depended on the source row count; on the GPU the plain
planned path (``ops.spmm``) is the default and this module is an
explicit alternative.

Values live in the format's reordered edge layout (like CSR keeps values
in CSR order): convert once with :func:`pack_values`; gradients flow in
the same layout and :func:`unpack_values` maps back to COO order.

The reference has no SpMM (unsupported list, /root/reference/README.md:45);
the functional contract is upstream's, /root/reference/README.md:267-300.
"""
import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .kernels.spmm_pallas import interpret_mode

SEG_ROWS = 1 << 17     # rows per source segment


class SegStructure(NamedTuple):
    """Device-resident reordered index structure (and its transpose).

    Edge stream order: row-block-major, then source segment, then row.
    ``col`` is SEGMENT-LOCAL (global col minus segment base).  Passed to
    jitted code as ARGUMENTS, never closures (large index arrays must not
    become constants of the compiled program).
    """
    col: jax.Array       # (nnz,) segment-local cols, reordered
    row: jax.Array       # (nnz,) block-LOCAL rows, reordered
    wptr: jax.Array      # (nblocks * S + 1,) window start per (block, seg)
    perm: jax.Array      # (nnz,) reordered position <- COO position
    # transpose structure (A^T) for the backward
    col_t: jax.Array
    row_t: jax.Array
    wptr_t: jax.Array
    perm_t: jax.Array    # reordered-T position <- COO position
    perm_ft: jax.Array   # fwd-packed -> transpose-packed value relay


class SegPlan(NamedTuple):
    """Static geometry for :func:`spmm_seg`."""
    num_rows: int
    num_cols: int
    rows_per_block: int      # CR (tile-aligned)
    window_cap: int          # EC per (block, seg) window, 2048-aligned
    num_segments: int
    rows_per_block_t: int
    window_cap_t: int
    num_segments_t: int
    seg_rows: int = SEG_ROWS
    interpret: bool = False


def _seg_order(row, col, num_rows: int, num_cols: int, CR: int,
               seg_rows: int):
    """One jitted pass: the (block, segment, row) edge reorder + window
    pointers.  Returns (perm, local_col, local_row, wptr, max_window)."""
    S = -(-num_cols // seg_rows)
    nblocks = -(-num_rows // CR)

    @functools.partial(jax.jit,
                       static_argnames=("S", "nblocks", "CR", "seg_rows",
                                        "num_rows"))
    def build(row, col, *, S, nblocks, CR, seg_rows, num_rows):
        # stable counting sort by (block, segment): edges arrive
        # row-sorted (block-contiguous, rows ascending within a block),
        # so a stable partition by segment within each block gives the
        # (block, segment, row) order WITHOUT a device argsort
        blk = (row // CR).astype(jnp.int32)
        seg = (col // seg_rows).astype(jnp.int32)
        bucket = blk * S + seg
        counts = jnp.zeros((nblocks * S,), jnp.int32).at[bucket].add(1)
        wptr = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                                jnp.cumsum(counts).astype(jnp.int32)])
        # rank of each edge within its bucket: per-segment running count
        # rebased at each block start (edges are block-contiguous)
        blk_start = jnp.searchsorted(
            row, jnp.arange(nblocks, dtype=row.dtype) * CR).astype(
            jnp.int32)
        rank = jnp.zeros(row.shape, jnp.int32)
        for s_i in range(S):
            m = (seg == s_i).astype(jnp.int32)
            cum = jnp.cumsum(m).astype(jnp.int32)
            base = jnp.take(
                jnp.concatenate([jnp.zeros((1,), jnp.int32), cum]),
                jnp.take(blk_start, blk, mode="clip"), mode="clip")
            rank = jnp.where(seg == s_i, cum - 1 - base, rank)
        pos = jnp.take(wptr, bucket, mode="clip") + rank
        nnz = row.shape[0]
        # inverse scatter: reordered slot pos[i] holds COO edge i
        perm = jnp.zeros((nnz,), jnp.int32).at[pos].set(
            jnp.arange(nnz, dtype=jnp.int32))
        row_r = jnp.take(row, perm)
        col_r = jnp.take(col, perm)
        seg_r = jnp.take(seg, perm)
        local_col = (col_r - (seg_r * seg_rows).astype(col_r.dtype)
                     ).astype(jnp.int32)
        local_row = (row_r % CR).astype(jnp.int32)
        return perm, local_col, local_row, wptr, counts.max()

    return build(row, col, S=S, nblocks=nblocks, CR=CR,
                 seg_rows=seg_rows, num_rows=num_rows), S, nblocks


def make_seg_plan(row, col, num_rows: int, num_cols: int, *,
                  feat_dim: int = 256,
                  target_bytes: int = 1024 * 1024 * 1024,
                  seg_rows: int = SEG_ROWS):
    """Host-side setup (eager; concrete indices).  Returns
    ``(plan, structure)`` for :func:`spmm_seg`.

    CONTRACT: ``row`` must be sorted ascending (canonical storage order,
    as produced by ``SparseStorage``/``PaddedCOO``) — the counting
    reorder in ``_seg_order`` and its ``blk_start`` searchsorted assume
    block-contiguous rows and silently mis-bucket unsorted input
    (ADVICE r3, low).  Planning is already eager, so this is checked
    here on host."""
    row = jnp.asarray(row, jnp.int32)
    col = jnp.asarray(col, jnp.int32)
    row_host = np.asarray(row)
    if row_host.size and not np.all(np.diff(row_host) >= 0):
        raise ValueError(
            "make_seg_plan requires row indices sorted ascending "
            "(canonical COO order); sort/coalesce the structure first")

    def cdiv(a, b):
        return -(-a // b)

    def geometry(num_r, num_c):
        # block rows sized so one block's product stream stays bounded
        nnz = int(row.shape[0])
        mean_edges_per_row = max(1, nnz // max(num_r, 1))
        budget_edges = max(2048, target_bytes // (feat_dim * 4))
        CR = max(128, min(num_r,
                          cdiv(budget_edges // mean_edges_per_row, 128)
                          * 128))
        return CR

    CR = geometry(num_rows, num_cols)
    (perm, lcol, lrow, wptr, wmax), S, nblocks = _seg_order(
        row, col, num_rows, num_cols, CR, seg_rows)
    EC = max(2048, cdiv(int(wmax), 2048) * 2048)

    CRT = geometry(num_cols, num_rows)
    # the transpose stream is not row-sorted: stable-sort by col first
    # (single int32 key), then the counting reorder applies; compose
    perm_c = jnp.argsort(col, stable=True).astype(jnp.int32)
    row_t_s = jnp.take(col, perm_c)
    col_t_s = jnp.take(row, perm_c)
    (perm_t2, lcol_t, lrow_t, wptr_t, wmax_t), S_t, _ = _seg_order(
        row_t_s, col_t_s, num_cols, num_rows, CRT, seg_rows)
    perm_t = jnp.take(perm_c, perm_t2)
    ECT = max(2048, cdiv(int(wmax_t), 2048) * 2048)

    plan = SegPlan(num_rows, num_cols, CR, EC, S, CRT, ECT, S_t,
                   seg_rows=seg_rows,
                   interpret=interpret_mode())
    perm_ft = jnp.take(_invert(perm), perm_t)
    structure = SegStructure(lcol, lrow, wptr, perm,
                             lcol_t, lrow_t, wptr_t, perm_t, perm_ft)
    return plan, structure


@jax.jit
def pack_values(s: SegStructure, value: jax.Array) -> jax.Array:
    """COO-ordered (nnz,) values -> the format's reordered layout (do this
    once per operand; the packed vector is the autograd leaf)."""
    return jnp.take(value, s.perm)


@jax.jit
def unpack_values(s: SegStructure, packed: jax.Array) -> jax.Array:
    """Inverse of :func:`pack_values` (packed layout -> COO order)."""
    return jnp.take(packed, _invert(s.perm))


@jax.jit
def _invert(perm):
    nnz = perm.shape[0]
    return jnp.zeros((nnz,), perm.dtype).at[perm].set(
        jnp.arange(nnz, dtype=perm.dtype))


def _fwd_oriented(plan: SegPlan, col, rowl, wptr, packed_value, x, *,
                  transpose: bool):
    """Blocked source-segmented SpMM over one orientation."""
    from .kernels.spmm_pallas import segment_rows_matmul

    if transpose:
        M, CR, EC, S = (plan.num_cols, plan.rows_per_block_t,
                        plan.window_cap_t, plan.num_segments_t)
    else:
        M, CR, EC, S = (plan.num_rows, plan.rows_per_block,
                        plan.window_cap, plan.num_segments)
    SR = plan.seg_rows
    nblocks = -(-M // CR)
    K = x.shape[1]
    nnz = col.shape[0]
    nsrc = x.shape[0]
    pdt = _stream_dtype(packed_value, x)
    x_n = x.astype(pdt)
    # pad the source so every segment slice is full-size
    pad_rows = S * SR - nsrc
    x_pad = jnp.concatenate(
        [x_n, jnp.zeros((pad_rows, K), pdt)]) if pad_rows else x_n
    col_pad = jnp.concatenate([col, jnp.zeros((EC,), jnp.int32)])
    row_pad = jnp.concatenate([rowl, jnp.full((EC,), CR, jnp.int32)])
    val_pad = None
    if packed_value is not None:
        val_pad = jnp.concatenate(
            [packed_value.astype(pdt), jnp.zeros((EC,), pdt)])

    arange_ec = jnp.arange(EC, dtype=jnp.int32)
    arange_cr = jnp.arange(CR + 1, dtype=jnp.int32)

    def block_fn(b):
        out_b = jnp.zeros((CR, K), jnp.float32)
        for s_i in range(S):
            w0 = wptr[b * S + s_i]
            cnt = wptr[b * S + s_i + 1] - w0
            cols_l = jax.lax.dynamic_slice(col_pad, (w0,), (EC,))
            rows_l = jax.lax.dynamic_slice(row_pad, (w0,), (EC,))
            valid = arange_ec < cnt
            rows_m = jnp.where(valid, rows_l, CR)
            # dynamic_slice + barrier: the source materializes as a
            # compact <= seg_rows-row buffer instead of fusing into the
            # gather
            x_seg = jax.lax.optimization_barrier(jax.lax.dynamic_slice(
                x_pad, (jnp.int32(s_i * SR), jnp.int32(0)), (SR, K)))
            prod = jnp.take(x_seg, cols_l, axis=0, mode="clip")
            if val_pad is not None:
                vals_l = jax.lax.dynamic_slice(val_pad, (w0,), (EC,))
                prod = prod * jnp.where(valid, vals_l,
                                        jnp.zeros((), pdt))[:, None]
            else:
                prod = prod * valid.astype(pdt)[:, None]
            rp_l = jnp.searchsorted(rows_m, arange_cr).astype(jnp.int32)
            out_b = out_b + segment_rows_matmul(
                prod, None, rp_l, CR, interpret=plan.interpret)
        return out_b

    out = jax.lax.map(block_fn, jnp.arange(nblocks, dtype=jnp.int32))
    return out.reshape(nblocks * CR, K)[:M]


def _stream_dtype(value, x):
    from .kernels.spmm_pallas import _product_dtype
    return _product_dtype(value, x)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def spmm_seg(plan: SegPlan, s: SegStructure,
             packed_value: Optional[jax.Array], x: jax.Array) -> jax.Array:
    """``A @ x`` (sum reduction) over a source-segmented plan,
    differentiable in ``(packed_value, x)``.

    ``packed_value``: values in the format's reordered layout
    (:func:`pack_values`), or a COO-ordered vector (converted on the
    fly — prefer packing once), or None for structural ones."""
    pv = _as_packed(s, packed_value)
    out = _fwd_oriented(plan, s.col, s.row, s.wptr, pv, x,
                        transpose=False)
    return out.astype(x.dtype)


def _as_packed(s, value):
    if value is None:
        return None
    return value


def _spmm_seg_fwd(plan, s, packed_value, x):
    return spmm_seg(plan, s, packed_value, x), (s, packed_value, x)


def _spmm_seg_bwd(plan, res, g):
    s, packed_value, x = res
    # d_x = A^T @ g over the transpose reorder; the value relay from the
    # forward layout to the transpose layout is one precomposed gather
    value_t = (jnp.take(packed_value, s.perm_ft)
               if packed_value is not None else None)
    d_x = _fwd_oriented(plan, s.col_t, s.row_t, s.wptr_t, value_t, g,
                        transpose=True).astype(x.dtype)
    d_value = (_sddmm_packed(plan, s, g, x).astype(packed_value.dtype)
               if packed_value is not None else None)
    d_s = jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, jax.dtypes.float0), s)
    return d_s, d_value, d_x


def _sddmm_packed(plan: SegPlan, s: SegStructure, g, x):
    """dv in the packed layout: per (block, segment) window, gather g rows
    from the block slice and x rows from the segment slice — both small
    sources (fast gather mode)."""
    M, CR, EC, S = (plan.num_rows, plan.rows_per_block,
                    plan.window_cap, plan.num_segments)
    SR = plan.seg_rows
    nblocks = -(-M // CR)
    K = x.shape[1]
    nnz = s.col.shape[0]
    nsrc = x.shape[0]
    pad_rows = S * SR - nsrc
    x_pad = jnp.concatenate(
        [x, jnp.zeros((pad_rows, K), x.dtype)]) if pad_rows else x
    g_pad = jnp.concatenate(
        [g, jnp.zeros((nblocks * CR - M + 1, K), g.dtype)])
    col_pad = jnp.concatenate([s.col, jnp.zeros((EC,), jnp.int32)])
    row_pad = jnp.concatenate([s.row, jnp.full((EC,), CR, jnp.int32)])
    arange_ec = jnp.arange(EC, dtype=jnp.int32)

    def block_fn(b):
        dvs = []
        for s_i in range(S):
            w0 = s.wptr[b * S + s_i]
            cnt = s.wptr[b * S + s_i + 1] - w0
            cols_l = jax.lax.dynamic_slice(col_pad, (w0,), (EC,))
            rows_l = jax.lax.dynamic_slice(row_pad, (w0,), (EC,))
            x_seg = jax.lax.optimization_barrier(jax.lax.dynamic_slice(
                x_pad, (jnp.int32(s_i * SR), jnp.int32(0)), (SR, K)))
            g_blk = jax.lax.optimization_barrier(jax.lax.dynamic_slice(
                g_pad, (b * CR, jnp.int32(0)), (CR, K)))
            xr = jnp.take(x_seg, cols_l, axis=0,
                          mode="clip").astype(jnp.float32)
            gr = jnp.take(g_blk, jnp.clip(rows_l, 0, CR - 1), axis=0,
                          mode="clip").astype(jnp.float32)
            dv = (xr * gr).sum(axis=1)
            dvs.append(jnp.where(arange_ec < cnt, dv, 0.0))
        return jnp.stack(dvs)          # (S, EC)

    dv = jax.lax.map(block_fn, jnp.arange(nblocks, dtype=jnp.int32))
    # paste windows back to packed order (valid slots unique)
    w0s = s.wptr[:-1].reshape(nblocks, S)
    cnts = (s.wptr[1:] - s.wptr[:-1]).reshape(nblocks, S)
    pos = w0s[:, :, None] + arange_ec[None, None, :]
    flat_pos = jnp.where(arange_ec[None, None, :] < cnts[:, :, None],
                         pos, nnz).reshape(-1)
    return jnp.zeros((nnz,), jnp.float32).at[flat_pos].set(
        dv.reshape(-1), mode="drop")


spmm_seg.defvjp(_spmm_seg_fwd, _spmm_seg_bwd)
