"""Static-shape (jittable) SpGEMM on PaddedCOO operands.

The jit counterpart of ``ops.spspmm.spspmm_eager`` (same ESC formulation —
see that module's docstring) with the two data-dependent sizes made static
(SURVEY.md §7 "hard parts" #1/#2):

* ``flop_capacity`` bounds the expansion stream (= multiplication count);
  compute it once on host via ``ops.spspmm.spgemm_flops`` plus slack.
* ``out_capacity`` bounds the coalesced output nnz.

Both are checked at runtime: overflow saturates ``nnz`` at capacity and the
returned ``overflowed`` flag lets callers detect truncation without a host
sync in the middle of a step.
"""
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .matrix import PaddedCOO


class SpGEMMResult(NamedTuple):
    matrix: PaddedCOO
    overflowed: jax.Array   # () bool — True if either capacity was exceeded


@partial(jax.jit, static_argnums=(2, 3))
def spspmm_padded(A: PaddedCOO, B: PaddedCOO, flop_capacity: int,
                  out_capacity: int) -> SpGEMMResult:
    """C = A @ B with A (M, K), B (K, N) both padded & row-sorted."""
    M, K = A.shape
    K2, N = B.shape
    assert K == K2, f"size mismatch {A.shape} @ {B.shape}"
    idx = A.row.dtype

    rowptrB = B.rowptr()                      # (K + 1,)

    # --- expansion sizes per A-edge ------------------------------------
    validA = A.valid_mask()
    colA = jnp.where(validA, A.col, 0)
    degB = jnp.where(validA, rowptrB[colA + 1] - rowptrB[colA], 0)
    ptrE = jnp.concatenate([jnp.zeros((1,), degB.dtype), jnp.cumsum(degB)])
    total = ptrE[-1]

    # --- materialize the padded multiplication stream ------------------
    # scatter+cummax expansion, not searchsorted: the binary search
    # lowers to ~log(nnz) chained full-stream gathers (~2.5 s at probe
    # scale, the real round-3 bottleneck — not the sort)
    from ..ops.convert import _expand_ptr
    t = jnp.arange(flop_capacity, dtype=ptrE.dtype)
    a_id = jnp.clip(_expand_ptr(ptrE, flop_capacity), 0, A.capacity - 1)
    valid_t = t < total
    b_pos = jnp.clip(rowptrB[colA[a_id]] + (t - ptrE[a_id]), 0,
                     B.capacity - 1)
    out_row = jnp.where(valid_t, A.row[a_id], M).astype(idx)
    out_col = jnp.where(valid_t, B.col[b_pos], N).astype(idx)

    if A.value is not None or B.value is not None:
        valA = (A.value if A.value is not None
                else jnp.where(validA, 1.0, 0.0))
        valB = (B.value if B.value is not None
                else jnp.where(B.valid_mask(), 1.0, 0.0))
        common = jnp.promote_types(valA.dtype, valB.dtype)
        prod = (valA[a_id].astype(common) * valB[b_pos].astype(common))
        prod = jnp.where(valid_t, prod, 0)
    else:
        prod = None

    # --- sort stream by output coordinate (pads (M, N) sort last) ------
    # single composite-key sort_key_val instead of a two-key lexsort +
    # two permutation gathers: the value rides along with the key and
    # (row, col) are decoded arithmetically — one sort pass, zero
    # scalar-gather passes (round-3 ESC tuning; scalar index ops are the
    # most expensive primitive on this toolchain).
    #
    # Key-range guard (ADVICE r3, high): with jax_enable_x64 off (the
    # production default) an astype(int64) silently demotes to int32 and
    # M*(N+1)+N can wrap negative — pads stop sorting last and the
    # decoded coordinates are garbage.  The composite key is only legal
    # when the full range fits the dtype that will actually be used;
    # otherwise fall back to a two-key lexicographic lax.sort (one fused
    # sort pass, no decode arithmetic).
    key_max = M * (N + 1) + N
    # int64 canonicalizes to int32 when x64 is off — that narrowed dtype
    # is what the arithmetic below would actually run in
    key_dtype = jax.dtypes.canonicalize_dtype(jnp.int64)
    if key_max <= jnp.iinfo(jnp.int32).max:
        key_dtype = jnp.int32
    if key_max <= jnp.iinfo(key_dtype).max:
        key = (out_row.astype(key_dtype) * (N + 1)
               + out_col.astype(key_dtype))
        if prod is not None:
            key, prod = jax.lax.sort_key_val(key, prod)
        else:
            key = jnp.sort(key)
        out_row = (key // (N + 1)).astype(idx)
        out_col = (key % (N + 1)).astype(idx)
    else:
        if prod is not None:
            out_row, out_col, prod = jax.lax.sort(
                (out_row, out_col, prod), num_keys=2)
        else:
            out_row, out_col = jax.lax.sort((out_row, out_col),
                                            num_keys=2)
    valid_t = out_row < M

    # --- compress: first-occurrence mask + segment-sum -----------------
    first = jnp.concatenate([
        valid_t[:1],
        valid_t[1:] & ((out_row[1:] != out_row[:-1]) |
                       (out_col[1:] != out_col[:-1])),
    ])
    seg = jnp.cumsum(first) - 1
    unique_count = jnp.sum(first)
    new_nnz = jnp.minimum(unique_count, out_capacity).astype(jnp.int32)

    slots = jnp.where(first & (seg < out_capacity), seg, out_capacity)
    rowC = jnp.full((out_capacity,), M, idx).at[slots].set(out_row,
                                                           mode="drop")
    colC = jnp.full((out_capacity,), N, idx).at[slots].set(out_col,
                                                           mode="drop")
    arange_out = jnp.arange(out_capacity)
    rowC = jnp.where(arange_out < new_nnz, rowC, M)
    colC = jnp.where(arange_out < new_nnz, colC, N)

    valC = None
    if prod is not None:
        seg_cl = jnp.where(valid_t & (seg < out_capacity), seg, out_capacity)
        valC = jax.ops.segment_sum(prod, seg_cl,
                                   num_segments=out_capacity + 1,
                                   indices_are_sorted=True)[:out_capacity]
        valC = jnp.where(arange_out < new_nnz, valC, 0)

    overflowed = (total > flop_capacity) | (unique_count > out_capacity)
    C = PaddedCOO(row=rowC, col=colC, value=valC, nnz=new_nnz, shape=(M, N))
    return SpGEMMResult(matrix=C, overflowed=overflowed)


def matmul_padded(A: PaddedCOO, B: PaddedCOO, flop_capacity: int,
                  out_capacity: int) -> PaddedCOO:
    """Convenience wrapper discarding the overflow flag."""
    return spspmm_padded(A, B, flop_capacity, out_capacity).matrix


@jax.custom_vjp
def _paired_gather(ivals, fvals, idx):
    """Gather ``(ivals[i], fvals[i])`` pairs with ONE 2-wide row gather
    (f32 bits ride in an int32 lane).  Differentiable in ``fvals`` via a
    custom VJP — ``bitcast_convert_type`` itself is not differentiable —
    whose backward is exactly what AD emits for a plain gather (a
    scatter-add of the cotangent).

    Out-of-range indices are CLAMPED, in both directions (ADVICE r4):
    the forward reads the boundary row, so its cotangent is scatter-added
    to that same boundary row — primal and gradient follow one index
    semantics."""
    idx = jnp.clip(idx, 0, ivals.shape[0] - 1)
    packed = jnp.stack(
        [ivals.astype(jnp.int32),
         jax.lax.bitcast_convert_type(fvals.astype(jnp.float32),
                                      jnp.int32)], axis=1)
    g = jnp.take(packed, idx, axis=0)
    return g[:, 0], jax.lax.bitcast_convert_type(g[:, 1], jnp.float32)


def _paired_gather_fwd(ivals, fvals, idx):
    idx_c = jnp.clip(idx, 0, ivals.shape[0] - 1)
    return _paired_gather(ivals, fvals, idx), (fvals.shape[0], idx_c)


def _paired_gather_bwd(res, ct):
    import numpy as np
    n, idx_c = res
    _, ct_f = ct
    d_f = jnp.zeros((n,), jnp.float32).at[idx_c].add(ct_f)
    return (np.zeros((n,), jax.dtypes.float0), d_f,
            np.zeros(idx_c.shape, jax.dtypes.float0))


_paired_gather.defvjp(_paired_gather_fwd, _paired_gather_bwd)


@partial(jax.custom_vjp, nondiff_argnums=(0, 1))
def _expand_holds_last(M, F, valA, b_off, rowA, le_e, le_keep):
    """Expand per-edge ``(b_off, valA)`` onto the (M, F) flop grid with
    holds-last semantics — equal to ``b_off[a_id]`` / ``valA[a_id]`` —
    WITHOUT any per-element gather: scatter per-edge DIFFS at the run
    starts and prefix-sum along the row.  Float values diff in their
    int32 BIT pattern (wrapping add/cumsum reconstructs exactly).
    It replaces a pair gather plus an ``a_id`` scatter-max grid.

    NOTE: no ``mode="drop"`` sentinel column — a scatter-ADD emitter was
    seen to mis-sum in-range updates when a drop-sentinel index column is
    present (scatter-MAX was unaffected).
    Dropped edges scatter an explicit zero at (row, 0) instead.

    Differentiable in ``valA`` via a custom VJP: the cotangent of edge e
    is the sum of the grid cotangent over its contiguous run
    ``[le_e, le_next)`` — two small gathers into a row cumsum, not a
    full-grid scatter."""
    nE = rowA.shape[0]
    eidx = jnp.arange(nE, dtype=jnp.int32)
    tag = jnp.where(le_keep, eidx, -1)
    prev_kept = jax.lax.cummax(
        jnp.concatenate([jnp.full((1,), -1, jnp.int32), tag[:-1]]))
    pk = jnp.clip(prev_kept, 0, nE - 1)
    chain = (prev_kept >= 0) & (rowA[pk] == rowA)
    vbits = jax.lax.bitcast_convert_type(
        valA.astype(jnp.float32), jnp.int32)
    d_boff = jnp.where(le_keep,
                       jnp.where(chain, b_off - b_off[pk], b_off), 0)
    d_bits = jnp.where(le_keep,
                       jnp.where(chain, vbits - vbits[pk], vbits), 0)
    r_idx = jnp.minimum(rowA, M - 1)
    le_in = jnp.where(le_keep, le_e, 0).astype(jnp.int32)
    boff_grid = jnp.cumsum(
        jnp.zeros((M, F), jnp.int32).at[r_idx, le_in].add(d_boff),
        axis=1)
    va_grid = jax.lax.bitcast_convert_type(
        jnp.cumsum(
            jnp.zeros((M, F), jnp.int32).at[r_idx, le_in].add(d_bits),
            axis=1), jnp.float32)
    return boff_grid, va_grid


def _ehl_fwd(M, F, valA, b_off, rowA, le_e, le_keep):
    out = _expand_holds_last(M, F, valA, b_off, rowA, le_e, le_keep)
    return out, (rowA, le_e, le_keep)


def _ehl_bwd(M, F, res, cts):
    import numpy as np
    rowA, le_e, le_keep = res
    _, ct_va = cts
    nE = rowA.shape[0]
    eidx = jnp.arange(nE, dtype=jnp.int32)
    nxt = jnp.concatenate([
        jnp.flip(jax.lax.cummin(jnp.flip(
            jnp.where(le_keep, eidx, nE))))[1:],
        jnp.full((1,), nE, jnp.int32)])
    nxt_cl = jnp.clip(nxt, 0, nE - 1)
    le_next = jnp.where((nxt < nE) & (rowA[nxt_cl] == rowA),
                        le_e[nxt_cl], F).astype(jnp.int32)
    r_idx = jnp.minimum(rowA, M - 1)
    ce = jnp.concatenate(
        [jnp.zeros((M, 1), ct_va.dtype), jnp.cumsum(ct_va, axis=1)],
        axis=1)
    lo = jnp.clip(le_e, 0, F).astype(jnp.int32)
    d_valA = jnp.where(le_keep,
                       ce[r_idx, le_next] - ce[r_idx, lo],
                       0.0).astype(jnp.float32)
    z = lambda a: np.zeros(a.shape, jax.dtypes.float0)  # noqa: E731
    return (d_valA, z(rowA), z(rowA), z(le_e), z(le_keep))


_expand_holds_last.defvjp(_ehl_fwd, _ehl_bwd)


@partial(jax.jit, static_argnums=(2, 3))
def spspmm_rowsorted(A: PaddedCOO, B: PaddedCOO, row_flop_capacity: int,
                     out_capacity: int) -> SpGEMMResult:
    """C = A @ B via ESC with a BATCHED per-row sort — the round-4 fast
    path (VERDICT r3 item 3; the reference's phmap-based intent,
    /root/reference/csrc/cpu/utils.h:4).

    The expansion stream inherits A's row order, so output rows are
    already sorted and the ESC sort only needs to order columns WITHIN
    each row.  Laying the stream out as an (M, F) grid (F =
    ``row_flop_capacity``, a static bound on any single row's
    multiplication count) turns the one global ``sort_key_val`` of
    :func:`spspmm_padded` into one vectorized batched sort along the
    minor axis, and
    the int32 column keys need no composite row*N+col encoding at all.

    Memory is O(M * F): use :func:`ops.spspmm.plan_spgemm_rows`, which
    falls back to the global-sort path when row skew inflates F.
    """
    M, K = A.shape
    K2, N = B.shape
    assert K == K2, f"size mismatch {A.shape} @ {B.shape}"
    idx = A.row.dtype
    F = row_flop_capacity

    rowptrB = B.rowptr()

    validA = A.valid_mask()
    colA = jnp.where(validA, A.col, 0)
    rowA = jnp.where(validA, A.row, M)
    degB = jnp.where(validA, rowptrB[colA + 1] - rowptrB[colA], 0)
    ptrE = jnp.concatenate([jnp.zeros((1,), degB.dtype),
                            jnp.cumsum(degB)])
    # per-output-row flop pointer (A is row-sorted; pads land in row M)
    row_flops = jax.ops.segment_sum(degB, rowA, num_segments=M + 1,
                                    indices_are_sorted=True)[:M]
    rowE = jnp.concatenate([jnp.zeros((1,), degB.dtype),
                            jnp.cumsum(row_flops)])

    # --- expansion laid out on the (M, F) grid -------------------------
    # edge e starts at local flop offset ptrE[e] - rowE[row(e)] within
    # its row; empty-fanout edges occupy no slot
    f_off = jnp.arange(F, dtype=ptrE.dtype)[None, :]
    gfi = rowE[:-1, None] + f_off                   # global flop index
    valid = f_off < row_flops[:, None]
    le_e = ptrE[:-1] - rowE[jnp.minimum(rowA, M)]
    le_keep = (degB > 0) & (le_e < F)
    gfi_c = jnp.minimum(gfi, jnp.maximum(ptrE[-1] - 1, 0))
    # per-edge b-offset precomposed so the expansion needs ONE (M, F)
    # lookup here instead of two chained ones (ptrE[a_id] then
    # rowptrB[colA[a_id]])
    b_off = (rowptrB[colA] - ptrE[:-1]).astype(jnp.int32)

    has_val = A.value is not None or B.value is not None
    if has_val:
        valA = (A.value if A.value is not None
                else jnp.where(validA, 1.0, 0.0))
        valB = (B.value if B.value is not None
                else jnp.where(B.valid_mask(), 1.0, 0.0))
        common = jnp.promote_types(valA.dtype, valB.dtype)

    if has_val and common == jnp.float32:
        # gather-free A-side expansion (round 5) — see
        # :func:`_expand_holds_last`
        boff_grid, va_grid = _expand_holds_last(
            M, F, valA.astype(jnp.float32), b_off, rowA,
            le_e.astype(jnp.int32), le_keep)
        b_pos = jnp.clip(boff_grid + gfi_c, 0, B.capacity - 1)
        colb_g, vb_g = _paired_gather(B.col, valB, b_pos.reshape(-1))
        key = jnp.where(valid, colb_g.reshape(M, F), N).astype(jnp.int32)
        prod = jnp.where(valid, va_grid * vb_g.reshape(M, F), 0.0)
    else:
        # a_id via 2-D scatter-max + per-row cummax (no binary search —
        # see spspmm_padded); F is the drop slot for empty-fanout edges
        le = jnp.where(le_keep, le_e, F)
        edge_ids = jnp.arange(A.capacity, dtype=jnp.int32)
        a0 = jnp.zeros((M, F), jnp.int32).at[
            jnp.minimum(rowA, M - 1), le].max(edge_ids, mode="drop")
        a_id = jnp.clip(jax.lax.cummax(a0, axis=1), 0, A.capacity - 1)
        b_pos = jnp.clip(b_off[a_id] + gfi_c, 0, B.capacity - 1)
        key = jnp.where(valid, B.col[b_pos], N).astype(jnp.int32)
        prod = (jnp.where(valid, valA[a_id].astype(common)
                          * valB[b_pos].astype(common), 0)
                if has_val else None)

    if prod is not None:
        key, prod = jax.lax.sort((key, prod), dimension=1, num_keys=1)
    else:
        key = jnp.sort(key, axis=1)

    # --- compress (flattened stream is (row, col)-sorted) --------------
    if prod is not None:
        prod = prod.reshape(-1)
    first2d = (key < N) & jnp.concatenate(
        [jnp.ones((M, 1), bool), key[:, 1:] != key[:, :-1]], axis=1)
    first = first2d.reshape(-1)
    out_col = key.reshape(-1)
    out_row = jnp.repeat(jnp.arange(M, dtype=idx), F,
                         total_repeat_length=M * F)
    seg = jnp.cumsum(first) - 1
    unique_count = jnp.sum(first)
    new_nnz = jnp.minimum(unique_count, out_capacity).astype(jnp.int32)

    # compress via sorted segment reductions (every element of a segment
    # shares (row, col), so max == the coordinate) — segment ops lower
    # better than the scatter emitter on this toolchain.
    #
    # The segment ids must stay MONOTONE to honor indices_are_sorted=True
    # (ADVICE r4, medium): a per-row pad sentinel interleaves between
    # rows, and the scatter emitter treats the hint as a promise.
    # ``seg`` is non-decreasing by construction (cumsum of a mask), so a
    # plain clip keeps it monotone; pad elements then land in their own
    # row's last open segment with ZERO contributions (prod and the
    # max-reduced coordinates are already masked to 0 below), which is
    # harmless.
    valid_flat = out_col < N
    seg_cl = jnp.clip(seg, 0, out_capacity)
    arange_out = jnp.arange(out_capacity)
    rowC = jax.ops.segment_max(
        jnp.where(valid_flat, out_row, 0), seg_cl,
        num_segments=out_capacity + 1,
        indices_are_sorted=True)[:out_capacity].astype(idx)
    colC = jax.ops.segment_max(
        jnp.where(valid_flat, out_col, 0), seg_cl,
        num_segments=out_capacity + 1,
        indices_are_sorted=True)[:out_capacity].astype(idx)
    rowC = jnp.where(arange_out < new_nnz, rowC, M)
    colC = jnp.where(arange_out < new_nnz, colC, N)

    valC = None
    if prod is not None:
        valC = jax.ops.segment_sum(prod, seg_cl,
                                   num_segments=out_capacity + 1,
                                   indices_are_sorted=True)[:out_capacity]
        valC = jnp.where(arange_out < new_nnz, valC, 0)

    overflowed = ((row_flops > F).any()
                  | (unique_count > out_capacity))
    C = PaddedCOO(row=rowC, col=colC, value=valC, nnz=new_nnz,
                  shape=(M, N))
    return SpGEMMResult(matrix=C, overflowed=overflowed)


@partial(jax.jit, static_argnums=(2, 3, 4, 5, 6))
def spspmm_rowblocked(A: PaddedCOO, B: PaddedCOO, row_flop_capacity: int,
                      out_capacity: int, block_rows: int,
                      block_edges: int, block_out: int) -> SpGEMMResult:
    """C = A @ B via the batched-row-sort ESC, streamed over ROW BLOCKS
    (round 5): the (M, F) grid of :func:`spspmm_rowsorted` is O(M * F)
    HBM — ~2 GB per array at a 10M-nnz A — so this variant materializes
    only one (block_rows, F) grid at a time and appends each block's
    compressed output at a carried offset.  Same formulation per block;
    blocks are row-disjoint so their outputs concatenate in row order.

    Static caps (from ``ops.spspmm.plan_spgemm_blocked``):
    ``block_edges`` bounds any block's A-edge count, ``block_out`` any
    block's output nnz.  Overflow of any cap is reported, not raised.

    Upstream intent: hash-based spspmm
    (/root/reference/csrc/cpu/utils.h:4); functional contract
    /root/reference/README.md:301-327.
    """
    M, K = A.shape
    K2, N = B.shape
    assert K == K2, f"size mismatch {A.shape} @ {B.shape}"
    idx = A.row.dtype
    F = row_flop_capacity
    MB, EB, BOC = block_rows, block_edges, block_out
    NB = -(-M // MB)

    rowptrB = B.rowptr()
    validA = A.valid_mask()
    colA = jnp.where(validA, A.col, 0)
    rowA = jnp.where(validA, A.row, M)
    degB = jnp.where(validA, rowptrB[colA + 1] - rowptrB[colA], 0)
    ptrE = jnp.concatenate([jnp.zeros((1,), degB.dtype),
                            jnp.cumsum(degB)])
    total_flops = ptrE[-1]
    row_flops = jax.ops.segment_sum(degB, rowA, num_segments=M + 1,
                                    indices_are_sorted=True)[:M]
    rowE = jnp.concatenate([jnp.zeros((1,), degB.dtype),
                            jnp.cumsum(row_flops)])
    eptrA = A.rowptr().astype(jnp.int32)
    b_off = (rowptrB[colA] - ptrE[:-1]).astype(jnp.int32)
    # per-edge local flop offset within its row (global precompute)
    le_g = ptrE[:-1] - rowE[jnp.minimum(rowA, M)]
    le_g = jnp.where((degB > 0) & (le_g < F), le_g,
                     F).astype(jnp.int32)

    has_val = A.value is not None or B.value is not None
    valA = (A.value if A.value is not None
            else jnp.where(validA, 1.0, 0.0)) if has_val else None
    valB = (B.value if B.value is not None
            else jnp.where(B.valid_mask(), 1.0, 0.0)) if has_val else None

    # padded per-edge streams so any (estart, EB) slice is legal
    def padE(a, fill):
        return jnp.concatenate(
            [a, jnp.full((EB,), fill, a.dtype)])

    rowA_p, le_p = padE(rowA, M), padE(le_g, F)
    boff_p = padE(b_off, 0)
    valA_p = padE(valA, 0.0) if has_val else None
    colA_p = padE(colA, 0)
    rf_pad = jnp.concatenate([row_flops,
                              jnp.zeros((MB,), row_flops.dtype)])
    rowE_pad = jnp.concatenate([rowE[:-1],
                                jnp.full((MB,), rowE[-1], rowE.dtype)])
    f_off = jnp.arange(F, dtype=ptrE.dtype)[None, :]
    local_ids = jnp.arange(EB, dtype=jnp.int32)
    arange_boc = jnp.arange(BOC)
    out_row0 = jnp.full((out_capacity + BOC,), M, idx)
    out_col0 = jnp.full((out_capacity + BOC,), N, idx)
    out_val0 = (jnp.zeros((out_capacity + BOC,),
                          jnp.promote_types(valA.dtype, valB.dtype))
                if has_val else None)

    def body(i, carry):
        rowC, colC, valC, noff, oflow = carry
        r0 = i * MB
        estart = eptrA[jnp.minimum(r0, M)]
        ecnt = eptrA[jnp.minimum(r0 + MB, M)] - estart
        rf_b = jax.lax.dynamic_slice(rf_pad, (r0,), (MB,))
        rowE_b = jax.lax.dynamic_slice(rowE_pad, (r0,), (MB,))
        rows_b = jnp.clip(
            jax.lax.dynamic_slice(rowA_p, (estart,), (EB,)) - r0,
            0, MB - 1)
        le_b = jnp.where(
            local_ids < ecnt,
            jax.lax.dynamic_slice(le_p, (estart,), (EB,)), F)
        gfi = rowE_b[:, None] + f_off
        gfi_c = jnp.minimum(gfi, jnp.maximum(total_flops - 1, 0))
        valid = f_off < rf_b[:, None]

        if has_val and valA.dtype == jnp.float32:
            # gather-free A-side expansion per block (round 5) — see
            # :func:`_expand_holds_last`; pad edges carry le == F, so
            # they are dropped by the keep mask and their clipped row
            # ids are harmless (they scatter zeros at (row, 0))
            keep_b = le_b < F
            boff_grid, va_grid = _expand_holds_last(
                MB, F,
                jax.lax.dynamic_slice(valA_p, (estart,), (EB,)),
                jax.lax.dynamic_slice(boff_p, (estart,), (EB,)),
                rows_b, jnp.where(keep_b, le_b, 0).astype(jnp.int32),
                keep_b)
            b_pos = jnp.clip(boff_grid + gfi_c, 0, B.capacity - 1)
            colb_g, vb_g = _paired_gather(B.col, valB,
                                          b_pos.reshape(-1))
            key = jnp.where(valid, colb_g.reshape(MB, F),
                            N).astype(jnp.int32)
            prod = jnp.where(valid,
                             va_grid * vb_g.reshape(MB, F), 0.0)
        else:
            a0 = jnp.zeros((MB, F), jnp.int32).at[rows_b, le_b].max(
                local_ids, mode="drop")
            a_loc = jnp.clip(jax.lax.cummax(a0, axis=1), 0, EB - 1)
            a_idg = (a_loc + estart).reshape(-1)
            b_pos = jnp.clip(
                jnp.take(boff_p, a_idg, mode="clip").reshape(MB, F)
                + gfi_c, 0, B.capacity - 1)
            key = jnp.where(valid, B.col[b_pos.reshape(-1)].reshape(
                MB, F), N).astype(jnp.int32)
            prod = (jnp.where(
                valid,
                (jnp.take(valA_p, a_idg).reshape(MB, F)
                 * valB[b_pos.reshape(-1)].reshape(MB, F)), 0)
                if has_val else None)

        if prod is not None:
            key, prod = jax.lax.sort((key, prod), dimension=1,
                                     num_keys=1)
            prod_f = prod.reshape(-1)
        else:
            key = jnp.sort(key, axis=1)
            prod_f = None

        first2d = (key < N) & jnp.concatenate(
            [jnp.ones((MB, 1), bool), key[:, 1:] != key[:, :-1]],
            axis=1)
        first = first2d.reshape(-1)
        out_col_f = key.reshape(-1)
        out_row_f = r0 + jnp.repeat(jnp.arange(MB, dtype=idx), F,
                                    total_repeat_length=MB * F)
        seg = jnp.cumsum(first) - 1
        uniq = jnp.sum(first)
        valid_f = out_col_f < N
        seg_cl = jnp.clip(seg, 0, BOC)
        row_b = jax.ops.segment_max(
            jnp.where(valid_f, out_row_f, 0), seg_cl,
            num_segments=BOC + 1,
            indices_are_sorted=True)[:BOC].astype(idx)
        col_b = jax.ops.segment_max(
            jnp.where(valid_f, out_col_f, 0), seg_cl,
            num_segments=BOC + 1,
            indices_are_sorted=True)[:BOC].astype(idx)
        nb = jnp.minimum(uniq, BOC).astype(jnp.int32)
        row_b = jnp.where(arange_boc < nb, row_b, M)
        col_b = jnp.where(arange_boc < nb, col_b, N)
        rowC = jax.lax.dynamic_update_slice(rowC, row_b, (noff,))
        colC = jax.lax.dynamic_update_slice(colC, col_b, (noff,))
        if prod_f is not None:
            val_b = jax.ops.segment_sum(
                prod_f, seg_cl, num_segments=BOC + 1,
                indices_are_sorted=True)[:BOC]
            val_b = jnp.where(arange_boc < nb, val_b, 0)
            valC = jax.lax.dynamic_update_slice(valC, val_b, (noff,))
        oflow = oflow | (uniq > BOC) | (ecnt > EB) | (rf_b > F).any()
        noff = jnp.minimum(noff + nb,
                           jnp.int32(out_capacity)).astype(jnp.int32)
        return rowC, colC, valC, noff, oflow

    rowC, colC, valC, noff, oflow = jax.lax.fori_loop(
        0, NB, body,
        (out_row0, out_col0, out_val0, jnp.int32(0), jnp.bool_(False)))
    rowC, colC = rowC[:out_capacity], colC[:out_capacity]
    valC = valC[:out_capacity] if valC is not None else None
    ar = jnp.arange(out_capacity)
    rowC = jnp.where(ar < noff, rowC, M)
    colC = jnp.where(ar < noff, colC, N)
    if valC is not None:
        valC = jnp.where(ar < noff, valC, 0)
    C = PaddedCOO(row=rowC, col=colC, value=valC,
                  nnz=noff.astype(jnp.int32), shape=(M, N))
    return SpGEMMResult(matrix=C, overflowed=oflow)
