"""Local/residual split SpMM for community-structured graphs.

On a clustered (reordered) graph most edges live near the diagonal
(co-purchase-like community structure).  The split partitions edges into
LOCAL (row block == col block) and RESIDUAL sub-matrices, plans each
separately, and sums two :func:`~.spmm_seg2.spmm_seg2` calls.  The local
plan's column range per row block is one community, so it can use a
small source slice; the residual is uniform-like.  Both calls share the
same dense operand and are differentiable, so the composite is too —
d_x adds, d_value splits.

Cites: /root/reference/README.md:267-300 (spmm contract; the reference
has no SpMM implementation at all — README.md:45).
"""
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from .spmm_seg2 import (Seg2Plan, Seg2Structure, make_seg2_plan,
                        pack_values, spmm_seg2)


class SplitPlan(NamedTuple):
    local: Seg2Plan
    resid: Seg2Plan
    block: int


class SplitStructure(NamedTuple):
    local: Seg2Structure
    resid: Seg2Structure
    idx_local: jax.Array   # (n_local,) COO positions of local edges
    idx_resid: jax.Array


def make_split_plan(row, col, num_rows: int, num_cols: int, *,
                    feat_dim: int, block: int = 2048, stream=None,
                    sr=None) -> Tuple[SplitPlan, SplitStructure]:
    """Partition edges by community block and plan each side.

    ``row`` must be sorted ascending (canonical COO order); each
    partition inherits sortedness.  Eager (concrete indices), like
    :func:`~.spmm_seg2.make_seg2_plan`."""
    row = jnp.asarray(row, jnp.int32)
    col = jnp.asarray(col, jnp.int32)
    local_mask = (row // block) == (col // block)
    # data-dependent partition — plan time is eager, exact sizes fine
    idx_local = jnp.where(local_mask)[0].astype(jnp.int32)
    idx_resid = jnp.where(~local_mask)[0].astype(jnp.int32)
    if int(idx_local.shape[0]) == 0 or int(idx_resid.shape[0]) == 0:
        raise ValueError(
            "split plan needs edges on BOTH sides of the block "
            "partition; use make_seg2_plan directly for one-sided "
            "structures")
    kw = dict(feat_dim=feat_dim, stream=stream, sr=sr)
    planL, sL = make_seg2_plan(jnp.take(row, idx_local),
                               jnp.take(col, idx_local),
                               num_rows, num_cols, **kw)
    planR, sR = make_seg2_plan(jnp.take(row, idx_resid),
                               jnp.take(col, idx_resid),
                               num_rows, num_cols, **kw)
    return (SplitPlan(local=planL, resid=planR, block=block),
            SplitStructure(local=sL, resid=sR, idx_local=idx_local,
                           idx_resid=idx_resid))


@jax.jit
def pack_values_split(s: SplitStructure, value: jax.Array):
    """COO-ordered values -> (packed_local, packed_resid) leaves."""
    return (pack_values(s.local, jnp.take(value, s.idx_local)),
            pack_values(s.resid, jnp.take(value, s.idx_resid)))


@jax.jit
def unpack_values_split(s: SplitStructure, packed) -> jax.Array:
    from .spmm_seg2 import unpack_values
    pvL, pvR = packed
    nnz = s.idx_local.shape[0] + s.idx_resid.shape[0]
    out = jnp.zeros((nnz,), pvL.dtype)
    out = out.at[s.idx_local].set(unpack_values(s.local, pvL))
    return out.at[s.idx_resid].set(unpack_values(s.resid, pvR))


def spmm_split(plan: SplitPlan, s: SplitStructure, packed_values,
               x: jax.Array) -> jax.Array:
    """``A @ x`` as local + residual passes; differentiable in
    ``(packed_values, x)`` (both sub-calls carry custom VJPs)."""
    if packed_values is None:
        pvL = pvR = None
    else:
        pvL, pvR = packed_values
    return (spmm_seg2(plan.local, s.local, pvL, x)
            + spmm_seg2(plan.resid, s.resid, pvR, x))
