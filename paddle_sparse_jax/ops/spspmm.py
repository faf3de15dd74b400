"""Sparse @ sparse matrix multiply (SpGEMM) via ESC (expand-sort-compress).

Not implemented by the reference (unsupported list,
``/root/reference/README.md:45-61``); upstream functional contract documented
at ``README.md:302-354``.  The upstream CPU path used a parallel hash map
(``csrc/cpu/utils.h:4``); hash maps don't vectorize into static-shape XLA, so this is the
sort-based ESC formulation (SURVEY.md §7 step 4):

1. *Expand*: every A-edge ``(i, k)`` fans out to all B-edges of row ``k``,
   producing a stream of ``(i, colB, valA * valB)`` triples whose length is
   the multiplication's FLOP count.
2. *Sort*: lexicographic (i, colB) stable sort.
3. *Compress*: first-occurrence mask + sorted segment-sum.

The expansion length is data-dependent, so the jittable variant takes a static
``capacity`` (padded, with a ``valid`` mask); the eager variant sizes exactly.

Gradients (value-only): native JAX AD over the expansion stream — the VJP of
``segment_sum(valA[a] * valB[b])`` is exactly the SDDMM-style sampled
products ``dvalA = (dC @ B^T)|_A``, ``dvalB = (A^T @ dC)|_B`` with no dense
intermediates, so autodiff emits what a hand-written rule would.
"""
import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from .convert import ptr2ind


class _Expansion(NamedTuple):
    a_ids: jax.Array   # (T,) which A-edge produced each triple
    b_pos: jax.Array   # (T,) which B-edge produced each triple
    out_row: jax.Array
    out_col: jax.Array


def _expand_eager(rowA, colA, rowptrB, colB) -> _Expansion:
    """Materialize the multiplication stream with exact (eager) length."""
    degB = rowptrB[colA + 1] - rowptrB[colA]
    ptrE = jnp.concatenate([jnp.zeros((1,), degB.dtype), jnp.cumsum(degB)])
    total = int(ptrE[-1])
    a_ids = ptr2ind(ptrE, total)
    within = jnp.arange(total, dtype=ptrE.dtype) - ptrE[a_ids]
    b_pos = rowptrB[colA[a_ids]] + within
    return _Expansion(a_ids=a_ids, b_pos=b_pos, out_row=rowA[a_ids],
                      out_col=colB[b_pos])


def _sample_products(exp: _Expansion, num_out: int, keep, valA, valB):
    """Segment-sum of valA[a_ids]*valB[b_pos] over output-entry segments.

    Differentiable in valA/valB: the segment-sum/gather transposes are the
    SDDMM-sampled gradient products."""
    prod = valA[exp.a_ids] * valB[exp.b_pos]
    seg_ids = jnp.cumsum(keep) - 1
    return jax.ops.segment_sum(prod, seg_ids, num_segments=num_out,
                               indices_are_sorted=True)


def spspmm_eager(rowA, colA, valA: Optional[jax.Array],
                 rowptrB, colB, valB: Optional[jax.Array],
                 M: int, N: int) -> Tuple[jax.Array, jax.Array, Optional[jax.Array]]:
    """Eager SpGEMM on exact shapes.

    Returns coalesced, row-sorted ``(rowC, colC, valC)`` of ``A @ B`` where A
    is (M, K) in sorted COO and B is (K, N) in CSR.  ``valC`` is None iff both
    inputs are structural (value-less); a single-sided value broadcasts
    against implicit ones.
    """
    rowA = jnp.asarray(rowA)
    colA = jnp.asarray(colA)
    rowptrB = jnp.asarray(rowptrB)
    colB = jnp.asarray(colB)

    if int(rowA.shape[0]) == 0 or int(colB.shape[0]) == 0:
        empty = jnp.zeros((0,), rowA.dtype)
        val = None if (valA is None and valB is None) else jnp.zeros((0,))
        return empty, empty, val

    exp = _expand_eager(rowA, colA, rowptrB, colB)
    total = int(exp.a_ids.shape[0])
    if total == 0:
        empty = jnp.zeros((0,), rowA.dtype)
        val = None if (valA is None and valB is None) else jnp.zeros((0,))
        return empty, empty, val

    # sort the triple stream by output coordinate
    perm = jnp.lexsort((exp.out_col, exp.out_row))
    exp = _Expansion(a_ids=exp.a_ids[perm], b_pos=exp.b_pos[perm],
                     out_row=exp.out_row[perm], out_col=exp.out_col[perm])

    keep = jnp.concatenate([
        jnp.ones((1,), dtype=jnp.int32),
        ((exp.out_row[1:] != exp.out_row[:-1]) |
         (exp.out_col[1:] != exp.out_col[:-1])).astype(jnp.int32),
    ])
    seg_starts = jnp.nonzero(keep)[0]
    rowC = exp.out_row[seg_starts]
    colC = exp.out_col[seg_starts]

    if valA is None and valB is None:
        return rowC, colC, None
    ones = lambda n, d: jnp.ones((n,), dtype=d)  # noqa: E731
    if valA is None:
        valA = ones(int(rowA.shape[0]), jnp.asarray(valB).dtype)
    if valB is None:
        valB = ones(int(colB.shape[0]), jnp.asarray(valA).dtype)
    common = jnp.promote_types(valA.dtype, valB.dtype)
    valC = _sample_products(exp, int(seg_starts.shape[0]), keep,
                            jnp.asarray(valA).astype(common),
                            jnp.asarray(valB).astype(common))
    return rowC, colC, valC


def spgemm_flops(rowptrA, colA, rowptrB) -> int:
    """Multiplication count of A @ B (size of the ESC expansion stream)."""
    degB = rowptrB[1:] - rowptrB[:-1]
    return int(degB[colA].sum())


@jax.jit
def _spgemm_flops_padded(colA, rowptrB, validA):
    """Multiplication count for padded operands — one jitted call."""
    colA_c = jnp.where(validA, colA, 0)
    degB = jnp.where(validA, rowptrB[colA_c + 1] - rowptrB[colA_c], 0)
    return degB.sum()


def plan_spgemm(A, B, slack: float = 1.1, exact_out: bool = True,
                align: int = 8):
    """Host-side capacity planner for :func:`core.spgemm.spspmm_padded`.

    Returns ``(flop_capacity, out_capacity)`` static ints: the expansion
    stream bound (multiplication count * ``slack``) and the coalesced
    output bound (exact unique count * ``slack`` when ``exact_out``, else
    equal to ``flop_capacity``).  ``slack`` > 1 leaves headroom so the
    plan survives modest structure growth without re-planning (capacities
    are static jit shapes).  Eager — needs concrete operands.

    Replaces hand-picked capacities (VERDICT round 1, item 8); the
    reference's phmap-based SpGEMM (/root/reference/csrc/cpu/utils.h:4)
    sized its hash tables dynamically, which static shapes cannot.
    """
    from ..core.matrix import PaddedCOO

    def cdiv(a, b):
        return -(-a // b)

    def rnd(v):
        return max(align, cdiv(int(v), align) * align)

    if not isinstance(A, PaddedCOO):
        A = A.to_padded()
    if not isinstance(B, PaddedCOO):
        B = B.to_padded()
    flops = int(_spgemm_flops_padded(A.col, B.rowptr(), A.valid_mask()))
    flop_capacity = rnd(max(1, flops) * slack)
    if not exact_out or flops == 0:
        return flop_capacity, flop_capacity
    from ..core.spgemm import spspmm_padded
    res = spspmm_padded(A.with_value(None), B.with_value(None),
                        flop_capacity, flop_capacity)
    unique = int(res.matrix.nnz)
    return flop_capacity, rnd(unique * slack)


@functools.partial(jax.jit, static_argnames=("M",))
def _row_flop_stats(rowA, colA, rowptrB, validA, *, M: int):
    colA_c = jnp.where(validA, colA, 0)
    degB = jnp.where(validA, rowptrB[colA_c + 1] - rowptrB[colA_c], 0)
    rf = jax.ops.segment_sum(degB, jnp.where(validA, rowA, M),
                             num_segments=M + 1,
                             indices_are_sorted=True)[:M]
    return rf.max(), degB.sum()


def plan_spgemm_rows(A, B, slack: float = 1.1, align: int = 8,
                     grid_budget: float = 4.0):
    """Capacity planner for :func:`core.spgemm.spspmm_rowsorted` (the
    batched-row-sort fast path).  Returns ``(row_flop_capacity,
    out_capacity)`` — or ``(None, ...)`` when row skew makes the (M, F)
    grid more than ``grid_budget`` times the flop count (power-law rows;
    fall back to :func:`core.spgemm.spspmm_padded`)."""
    from ..core.matrix import PaddedCOO

    def cdiv(a, b):
        return -(-a // b)

    def rnd(v):
        return max(align, cdiv(int(v), align) * align)

    if not isinstance(A, PaddedCOO):
        A = A.to_padded()
    if not isinstance(B, PaddedCOO):
        B = B.to_padded()
    M = A.shape[0]
    max_rf, flops = _row_flop_stats(A.row, A.col, B.rowptr(),
                                    A.valid_mask(), M=M)
    max_rf, flops = int(max_rf), int(flops)
    if flops == 0:
        return None, align
    F = rnd(max_rf)
    if M * F > grid_budget * flops + (1 << 22):
        return None, rnd(flops * slack)
    return F, rnd(min(flops, M * F) * slack)


def plan_spgemm_blocked(A, B, slack: float = 1.15, align: int = 8,
                        grid_elems: int = 48_000_000):
    """Capacity planner for :func:`core.spgemm.spspmm_rowblocked` (the
    memory-scalable row-blocked fast path, round 5).

    Returns ``(F, out_capacity, block_rows, block_edges, block_out)``
    or ``None`` when row skew makes the per-row grid infeasible (F
    would exceed the whole block grid — power-law rows; fall back to
    :func:`core.spgemm.spspmm_padded`).  ``grid_elems`` bounds the
    transient (block_rows, F) grid (~8 arrays of this many elements
    live per block).
    """
    import jax.numpy as jnp

    from ..core.matrix import PaddedCOO

    def cdiv(a, b):
        return -(-a // b)

    def rnd(v, m=align):
        return max(m, cdiv(int(v), m) * m)

    if not isinstance(A, PaddedCOO):
        A = A.to_padded()
    if not isinstance(B, PaddedCOO):
        B = B.to_padded()
    M = A.shape[0]
    max_rf, flops = _row_flop_stats(A.row, A.col, B.rowptr(),
                                    A.valid_mask(), M=M)
    max_rf, flops = int(max_rf), int(flops)
    if flops == 0:
        return None
    F = rnd(max_rf)
    # row-skew infeasibility (mirrors plan_spgemm_rows): a hot row makes
    # the per-row grid mostly padding, and a huge F starves the block
    # height — fall back to the global-sort ESC
    MB = min(M, max(128, grid_elems // F))
    NB = cdiv(M, MB)
    if NB * MB * F > 4.0 * flops + (1 << 22) or F > grid_elems // 128:
        return None

    @functools.partial(jax.jit, static_argnames=("mb", "nb", "m"))
    def block_stats(rowA, colA, rowptrB, validA, eptr, *, mb, nb, m):
        colA_c = jnp.where(validA, colA, 0)
        degB = jnp.where(validA,
                         rowptrB[colA_c + 1] - rowptrB[colA_c], 0)
        rf = jax.ops.segment_sum(
            degB, jnp.where(validA, rowA, m), num_segments=m + 1,
            indices_are_sorted=True)[:m]
        rf_pad = jnp.concatenate(
            [rf, jnp.zeros((nb * mb - m,), rf.dtype)])
        blk_flops = rf_pad.reshape(nb, mb).sum(axis=1)
        bounds = eptr[jnp.minimum(
            jnp.arange(nb + 1, dtype=jnp.int32) * mb, m)]
        blk_edges = bounds[1:] - bounds[:-1]
        return blk_flops.max(), blk_edges.max()

    mbf, mbe = block_stats(A.row, A.col, B.rowptr(), A.valid_mask(),
                           A.rowptr(), mb=MB, nb=NB, m=M)
    EB = rnd(int(mbe) * 1.02 + 8)
    # block output <= block flops; block flops also caps the total
    BOC = rnd(min(int(mbf), MB * F) * slack)
    out_capacity = rnd(min(flops, M * F) * slack)
    return F, out_capacity, MB, EB, BOC
