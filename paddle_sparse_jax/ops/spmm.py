"""Sparse @ dense matrix multiply (SpMM) — the framework's hottest kernel.

The reference does not implement ``spmm`` (unsupported list,
``/root/reference/README.md:45-61``); the upstream functional contract is
documented at ``README.md:267-300`` and is what this module provides:

* forward ``sum``/``mean``: on the GPU, the fused CSR kernel
  (``ops/kernels/spmm_pallas.py``) gathers rows of the dense operand by
  ``col``, scales by ``value`` and reduces each row in registers; on the
  CPU, an XLA gather + sorted segment-sum.  Concrete structures are
  planned once (:func:`make_spmm_plan`: CSC view, hot-row split) and
  their backward runs the same kernel over A^T; traced structures sort
  by column inside the backward.
* forward ``min``/``max``: segment-min/max of products, empty rows zeroed.
* gradients of the XLA formulation: native JAX AD — the VJP of
  gather+segment-sum is the transpose SpMM (scatter by ``col``) plus an
  SDDMM-style sampled dot for ``d value``.  Index arrays are
  integer-typed and therefore automatically non-differentiable, matching
  the reference's value-only autograd (``README.md:96``).

All entry points take ``num_rows`` / ``reduce`` statically, so they work both
eagerly (exact nnz) and under ``jit`` (padded buffers; pad with ``value = 0``,
``col = 0``, ``row = num_rows`` so padding lands in a dead row slot sliced off
by the caller — see ``core.matrix``).
"""
import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp


def _expand(value: jax.Array, ndim_extra: int) -> jax.Array:
    return value.reshape(value.shape + (1,) * ndim_extra)


def _products(col, value, x):
    # mode="clip": padded entries carry col == N (one past the end); they
    # either have value 0 or land in the dead output row the caller slices
    # off, and clipping keeps eager (unjitted) evaluation legal.
    products = jnp.take(x, col, axis=0, mode="clip")
    if value is not None:
        products = products * _expand(value, x.ndim - 1)
    return products


def _row_counts(row, num_rows, dtype):
    return jax.ops.segment_sum(jnp.ones(row.shape, dtype), row,
                               num_segments=num_rows, indices_are_sorted=True)


def _kernel_applicable(x, value, reduce) -> bool:
    """The fused kernel covers sum/mean over a 2-D f32/bf16 operand with
    scalar (or implicit) edge values."""
    kernel_dtypes = (jnp.float32, jnp.bfloat16)
    return (reduce in ("sum", "add", "mean") and x.ndim == 2
            and x.dtype in kernel_dtypes
            and (value is None or (jnp.ndim(value) == 1
                                   and jnp.result_type(value)
                                   in kernel_dtypes)))


def _transpose_sorted(row, col, num_cols: int):
    """CSC view of a row-sorted COO structure as a CSR of A^T: ``perm``
    (stable sort by col), ``rowptr_t``, ``col_t`` (= row[perm]).  Entries
    with ``col >= num_cols`` (padding) sort past ``rowptr_t[-1]``."""
    from .convert import ind2ptr
    perm = jnp.argsort(col, stable=True)
    rowptr_t = ind2ptr(jnp.take(col, perm), num_cols)
    return perm, rowptr_t, jnp.take(row, perm)


def _transpose_grads(rowptr_t, col_t, perm, value, g, x, row, col,
                     interpret=None, fold_t=None, num_cols=None):
    """``(d_value, d_x)`` of ``out = A @ x`` from A^T stored as CSR
    (``rowptr_t``, ``col_t``, CSC ``perm``).  For ``K`` within the fused
    limit one kernel pass computes both: the value gradient shares the
    gathered ``g`` rows with the transpose SpMM; wider operands run the
    transpose SpMM and a chunked SDDMM.  ``fold_t`` collapses split
    pseudo-columns back to ``num_cols`` real ones."""
    from .kernels.spmm_pallas import (FUSED_SDDMM_MAX_K, csr_spmm,
                                      csr_spmm_sddmm, sddmm_dot_chunked)
    value_t = None if value is None else jnp.take(value, perm)
    g = g.astype(x.dtype)
    fused = value is not None and x.shape[1] <= FUSED_SDDMM_MAX_K
    if fused:
        n_t = rowptr_t.shape[0] - 1
        y = x if fold_t is None or fold_t.shape[0] == 0 else \
            jnp.take(x, fold_t, axis=0)
        d_x, dv_t = csr_spmm_sddmm(rowptr_t, col_t, value_t, g, y[:n_t],
                                   interpret=interpret)
        # edges past rowptr_t[-1] (padding columns) get no dot: zero them
        nnz = perm.shape[0]
        dv_t = jnp.where(jnp.arange(nnz) < rowptr_t[-1], dv_t, 0.0)
        d_value = jnp.zeros((nnz,), jnp.float32).at[perm].set(
            dv_t, unique_indices=True).astype(value.dtype)
    else:
        d_x = csr_spmm(rowptr_t, col_t, value_t, g, interpret=interpret)
        d_value = (None if value is None else sddmm_dot_chunked(
            row, col, g, x, out_dtype=value.dtype))
    if fold_t is not None:
        d_x = _fold_rows(d_x, fold_t, num_cols)
    return d_value, d_x.astype(x.dtype)


def _spmm_sum_kernel_vjp(row, col, rowptr, num_rows):
    """Kernel forward + custom VJP for traced index structures.

    Closes over the (non-differentiable) index structure so the custom_vjp
    is over (value, x) only — reference semantics: autograd on values.
    The backward sorts the structure by column and runs the kernel over
    A^T (:func:`_transpose_grads`)."""
    from .kernels.spmm_pallas import csr_spmm

    @jax.custom_vjp
    def f(value, x):
        return csr_spmm(rowptr, col, value, x).astype(x.dtype)

    def fwd(value, x):
        return f(value, x), (value, x)

    def bwd(res, g):
        value, x = res
        perm, rowptr_t, col_t = _transpose_sorted(row, col, x.shape[0])
        return _transpose_grads(rowptr_t, col_t, perm, value, g, x, row,
                                col)

    f.defvjp(fwd, bwd)
    return f


class SpmmStructure(NamedTuple):
    """Device-resident index structure for :func:`spmm_planned`.

    CSR of A plus the CSC view as a CSR of A^T (``rowptr_t = colptr``,
    ``col_t = row[perm]``) and the sorting permutation for edge values.  Passed to jitted code as arguments, never
    closed over, so a large graph's index arrays do not become constants
    of the compiled program.

    ``rowptr``/``rowptr_t`` are PSEUDO-row pointers: rows longer than the
    plan's split cap are cut into pseudo-rows (a pure refinement of the
    pointer — the edge stream is untouched), so one hot row cannot
    serialise a whole kernel program on a power-law graph.
    ``fold``/``fold_t`` map pseudo-rows back to real rows for the cheap
    post-reduction."""
    rowptr: jax.Array
    row: jax.Array
    col: jax.Array
    rowptr_t: jax.Array
    col_t: jax.Array
    perm: jax.Array
    fold: jax.Array      # (num_pseudo,) pseudo-row -> row
    fold_t: jax.Array    # (num_pseudo_t,) pseudo-col -> col


class SpmmPlan(NamedTuple):
    """Static (hashable) plan for :func:`spmm_planned`."""
    num_rows: int
    num_cols: int
    num_pseudo: int = -1       # -1 => equals num_rows (no splitting)
    num_pseudo_t: int = -1
    interpret: bool = False
    # stream dtype choice, snapshotted from PSP_SPMM_STREAM at plan-build
    # time and threaded through as a static jit arg so the compiled
    # executable is keyed on it
    stream: str = "f32"


@functools.partial(jax.jit, static_argnames=("num_rows", "num_cols"))
def _spmm_structure(row, col, *, num_rows: int, num_cols: int):
    """CSR + CSC index structure in one compiled program."""
    from .convert import ind2ptr
    rowptr = ind2ptr(row, num_rows)
    perm = jnp.argsort(col, stable=True)
    col_t = jnp.take(row, perm)
    colptr = ind2ptr(jnp.take(col, perm), num_cols)   # sorted: rows of A^T
    return rowptr, perm, col_t, colptr


def _split_long_rows(rowptr_np, cap: int):
    """Refine a CSR pointer so no (pseudo-)row exceeds ``cap`` edges.

    Pure pointer refinement — the edge stream is untouched.  Returns
    ``(rowptr_pseudo, fold)`` with ``fold[p]`` the real row of pseudo-row
    ``p``; identity (``None`` fold) when nothing was split."""
    import numpy as np
    deg = np.diff(rowptr_np)
    splits = np.maximum(1, -(-deg // cap))
    P = int(splits.sum())
    M = deg.shape[0]
    if P == M:
        return rowptr_np, None
    fold = np.repeat(np.arange(M, dtype=np.int64), splits)
    starts = np.concatenate([[0], np.cumsum(splits)[:-1]])
    k = np.arange(P, dtype=np.int64) - starts[fold]
    ptr = np.minimum(rowptr_np[fold] + k * cap, rowptr_np[fold + 1])
    return (np.concatenate([ptr, rowptr_np[-1:]]),
            fold.astype(np.int32))


# longest (pseudo-)row one kernel program walks: ~80x the mean degree of
# an ogbn-products-shaped graph, so only genuinely hot rows are split
ROW_SPLIT = 4096


def make_spmm_plan(row, col, num_rows: int, num_cols: int,
                   row_split: int = ROW_SPLIT):
    """Host-side setup for repeated SpMM on one structure: builds the CSC
    permutation and the pseudo-row split once (eager; requires concrete
    indices).  Returns ``(plan, structure)`` for :func:`spmm_planned`."""
    import numpy as np

    from .kernels.spmm_pallas import _stream_env, interpret_mode
    row = jnp.asarray(row)
    col = jnp.asarray(col)
    rowptr, perm, col_t, colptr = _spmm_structure(
        row, col, num_rows=num_rows, num_cols=num_cols)
    rp_np, fold = _split_long_rows(np.asarray(rowptr, np.int64), row_split)
    cp_np, fold_t = _split_long_rows(np.asarray(colptr, np.int64),
                                     row_split)
    plan = SpmmPlan(num_rows, num_cols,
                    num_pseudo=int(rp_np.shape[0]) - 1,
                    num_pseudo_t=int(cp_np.shape[0]) - 1,
                    interpret=interpret_mode(), stream=_stream_env())
    idx = jnp.int32
    structure = SpmmStructure(
        jnp.asarray(rp_np, idx), row, col, jnp.asarray(cp_np, idx),
        col_t, perm,
        fold=(jnp.asarray(fold) if fold is not None
              else jnp.zeros((0,), idx)),
        fold_t=(jnp.asarray(fold_t) if fold_t is not None
                else jnp.zeros((0,), idx)))
    return plan, structure


def _fold_rows(out, fold, num_rows: int):
    """Collapse split pseudo-rows back to real rows (sorted segments)."""
    if int(out.shape[0]) == num_rows:
        return out
    return jax.ops.segment_sum(out, fold, num_segments=num_rows,
                               indices_are_sorted=True)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def spmm_planned(plan: SpmmPlan, s: SpmmStructure,
                 value: Optional[jax.Array], x: jax.Array) -> jax.Array:
    """Fused-kernel SpMM (sum) over a planned structure, differentiable in
    ``(value, x)``.  The backward runs the kernel over the CSC structure
    (a sorted transpose SpMM, no scatter) with the value gradient in the
    same pass (:func:`_transpose_grads`)."""
    from .kernels.spmm_pallas import _product_dtype, csr_spmm
    pdt = _product_dtype(value, x, plan.stream)
    out = csr_spmm(s.rowptr, s.col,
                   None if value is None else value.astype(pdt),
                   x.astype(pdt), interpret=plan.interpret)
    out = _fold_rows(out, s.fold, plan.num_rows)
    return out.astype(x.dtype)


def _spmm_planned_fwd(plan, s, value, x):
    return spmm_planned(plan, s, value, x), (s, value, x)


def _spmm_planned_bwd(plan, res, g):
    import numpy as np

    from .kernels.spmm_pallas import _product_dtype
    s, value, x = res
    pdt = _product_dtype(value, g, plan.stream)
    d_value, d_x = _transpose_grads(
        s.rowptr_t, s.col_t, s.perm,
        None if value is None else value.astype(pdt), g.astype(pdt),
        x.astype(pdt), s.row, s.col, interpret=plan.interpret,
        fold_t=s.fold_t, num_cols=plan.num_cols)
    if value is not None:
        d_value = d_value.astype(value.dtype)
    d_s = jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, jax.dtypes.float0), s)
    return d_s, d_value, d_x.astype(x.dtype)


spmm_planned.defvjp(_spmm_planned_fwd, _spmm_planned_bwd)


# plan caches: keyed on the col array's identity (jax.Arrays are
# unhashable, so id + weakref liveness check) so repeated eager calls on
# the same sparse structure plan once
_SPMM_PLAN_CACHE = {}
_SELL_CACHE = {}


def _cached_spmm_plan(row, col, num_rows: int, num_cols: int,
                      key_row=None, key_col=None):
    """Plan cache keyed on the CALLER'S index objects.

    ``key_row``/``key_col`` default to ``row``/``col`` but callers that
    convert inputs first (``spmm_coo`` runs ``jnp.asarray`` before
    dispatch) pass the pre-conversion objects — otherwise a numpy/list
    input mints a fresh jax array (new ``id``) per call and the full plan
    build reruns on every eager invocation.  Mutating a cached numpy index
    array in place yields a stale plan; reconstruct the array instead."""
    import weakref
    key_row = row if key_row is None else key_row
    key_col = col if key_col is None else key_col
    key = id(key_col)
    ent = _SPMM_PLAN_CACHE.get(key)
    if (ent is not None and ent[0]() is key_col and ent[1]() is key_row
            and ent[2] == (num_rows, num_cols)):
        return ent[3], ent[4]
    plan, structure = make_spmm_plan(row, col, num_rows, num_cols)
    try:
        _SPMM_PLAN_CACHE[key] = (
            weakref.ref(key_col,
                        lambda _: _SPMM_PLAN_CACHE.pop(key, None)),
            weakref.ref(key_row), (num_rows, num_cols), plan, structure)
    except TypeError:       # unweakrefable index type (e.g. np scalar)
        pass
    return plan, structure


def _cached_sell_plan(row, col, num_rows: int, num_cols: int,
                      feat_dim: int, key_row=None, key_col=None):
    import weakref

    from .spmm_sell import make_sell_plan
    key_row = row if key_row is None else key_row
    key_col = col if key_col is None else key_col
    key = id(key_col)
    ent = _SELL_CACHE.get(key)
    if (ent is not None and ent[0]() is key_col and ent[1]() is key_row
            and ent[2] == (num_rows, num_cols)):
        return ent[3], ent[4]
    plan, structure = make_sell_plan(row, col, num_rows, num_cols,
                                     feat_dim=feat_dim)
    try:
        _SELL_CACHE[key] = (
            weakref.ref(key_col, lambda _: _SELL_CACHE.pop(key, None)),
            weakref.ref(key_row), (num_rows, num_cols), plan, structure)
    except TypeError:       # unweakrefable index type (e.g. np scalar)
        pass
    return plan, structure


def _sell_applicable(x, reduce) -> bool:
    return (reduce in ("sum", "add") and x.ndim == 2
            and jnp.issubdtype(x.dtype, jnp.floating))


def spmm_coo(row: jax.Array, col: jax.Array, value: Optional[jax.Array],
             x: jax.Array, num_rows: int, reduce: str = "sum",
             backend: str = "auto") -> jax.Array:
    """``out[m] = reduce_{e: row[e]=m} value[e] * x[col[e]]``.

    ``row`` must be sorted ascending (canonical storage order).  ``value``
    may be ``None`` (implicit ones).  ``num_rows`` and ``reduce`` are static.
    Differentiable in ``value`` and ``x``.

    ``backend``: "auto" takes the fused kernel on the GPU (through a
    cached plan for concrete index structures, through a sort-based
    custom VJP for traced ones) and the XLA segment formulation on the
    CPU.  "xla" / "pallas" / "sell" force a path; "pallas" on the CPU
    runs the kernel in interpret mode.  The padded-group "sell" path is
    explicit-only.
    """
    from jax._src import core as jax_core

    from .kernels.spmm_pallas import _lowering_platform
    # a plan needs concrete indices AND no enclosing trace: arrays closed
    # over by a jitted function are concrete but the plan build would be
    # traced
    concrete = not (isinstance(row, jax.core.Tracer)
                    or isinstance(col, jax.core.Tracer)
                    or not jax_core.trace_state_clean())
    row_in, col_in = row, col   # pre-asarray objects: plan-cache keys
    row = jnp.asarray(row)
    col = jnp.asarray(col)

    if backend == "sell":
        if not (concrete and _sell_applicable(x, reduce)):
            raise ValueError(
                "backend='sell' needs concrete (non-traced) indices, a 2-D "
                "float dense operand and reduce='sum' — build a plan with "
                "ops.spmm_sell.make_sell_plan for jitted use")
        from .spmm_sell import spmm_sell
        if value is not None:
            value = jnp.asarray(value)
        plan, structure = _cached_sell_plan(row, col, num_rows,
                                            int(x.shape[0]),
                                            int(x.shape[-1]),
                                            key_row=row_in,
                                            key_col=col_in)
        return spmm_sell(plan, structure, value, x)

    if value is not None:
        value = jnp.asarray(value)
        if value.ndim != 1:
            raise ValueError("spmm expects scalar edge values (1-D)")
        common = jnp.promote_types(value.dtype, x.dtype)
        value = value.astype(common)
        x = x.astype(common)

    use_kernel = (backend == "pallas"
                  or (backend == "auto"
                      and _lowering_platform() in ("gpu", "cuda")))
    if use_kernel and _kernel_applicable(x, value, reduce):
        # concrete structures plan once (cached per structure identity);
        # traced ones sort by column inside the backward
        if concrete:
            plan, structure = _cached_spmm_plan(row, col, num_rows,
                                                int(x.shape[0]),
                                                key_row=row_in,
                                                key_col=col_in)
            out = spmm_planned(plan, structure, value, x)
        else:
            from .convert import ind2ptr
            rowptr = ind2ptr(row, num_rows)
            out = _spmm_sum_kernel_vjp(row, col, rowptr, num_rows)(value, x)
        if reduce == "mean":
            deg = jnp.maximum(_row_counts(row, num_rows, out.dtype), 1)
            out = out / deg[:, None]
        return out

    if reduce in ("sum", "add", "mean"):
        out = jax.ops.segment_sum(_products(col, value, x), row,
                                  num_segments=num_rows,
                                  indices_are_sorted=True)
        if reduce == "mean":
            deg = _row_counts(row, num_rows, out.dtype)
            deg = jnp.maximum(deg, 1).reshape((-1,) + (1,) * (out.ndim - 1))
            out = out / deg
        return out

    if reduce in ("min", "max"):
        fn = jax.ops.segment_max if reduce == "max" else jax.ops.segment_min
        out = fn(_products(col, value, x), row, num_segments=num_rows,
                 indices_are_sorted=True)
        counts = _row_counts(row, num_rows, jnp.int32)
        mask = (counts == 0).reshape((-1,) + (1,) * (out.ndim - 1))
        return jnp.where(mask, jnp.zeros((), out.dtype), out)

    raise ValueError(f"unknown reduction {reduce!r}")


def spmm_csr(rowptr: jax.Array, col: jax.Array, value: Optional[jax.Array],
             x: jax.Array, reduce: str = "sum",
             backend: str = "auto") -> jax.Array:
    """CSR entry point: derives sorted COO rows from ``rowptr``."""
    from .convert import ptr2ind
    num_rows = int(rowptr.shape[0]) - 1
    row = ptr2ind(rowptr, int(col.shape[0]))
    return spmm_coo(row, col, value, x, num_rows, reduce, backend=backend)
