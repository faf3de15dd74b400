"""2-D block-partitioned SpMM with ``psum_scatter`` reduction.

The "sparse tensor parallel" strategy from SURVEY.md §2.4 (the one row of
that table round 1 left unimplemented): A is split into a (Dr x Dc) grid of
blocks, the dense operand's rows are sharded over the ``dc`` axis (and
replicated over ``dr``), and each device computes its block partial
``A[i, j] @ x[j]``.  The partials are reduced across ``dc`` with
``psum_scatter``, which simultaneously sums and splits the output rows over
``dc`` — so the result is sharded over BOTH axes ((M / (Dr*Dc)) rows per
device) and no device ever holds a full row block.  Communication per
device is O(M/Dr * K / Dc), carried by the reduce-scatter.

Compared to the 1-D strategies (``spmm_allgather`` / ``spmm_ring`` /
``spmm_halo``), the 2-D grid bounds BOTH operand-side halo (each device
only needs x rows of its column block) and output-side reduction traffic,
which is what scales at papers100M sizes where neither all-gather nor a
full ring fits.

The reference has no distributed layer at all (SURVEY.md §2.4).
"""
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.spmm import spmm_coo


class Sharded2DMatrix(NamedTuple):
    """(Dr, Dc) grid of COO blocks with a common padded capacity.

    ``row`` block-local in [0, M/Dr] (pad = M/Dr, dead slot); ``col``
    block-local in [0, N/Dc) (pad = 0 with value 0).  Rows ascending
    within each block.
    """
    row: jax.Array     # (Dr, Dc, C)
    col: jax.Array     # (Dr, Dc, C)
    value: jax.Array   # (Dr, Dc, C)
    shape: Tuple[int, int]
    grid: Tuple[int, int]


def make_mesh_2d(dr: int, dc: int, axis_names=("dr", "dc"),
                 devices=None) -> Mesh:
    """(dr x dc) mesh; ``devices`` defaults to the default backend's and
    must hold at least ``dr * dc`` devices."""
    import numpy as np
    if devices is None:
        devices = jax.devices()
    if len(devices) < dr * dc:
        raise RuntimeError(
            f"need {dr * dc} devices for a {dr}x{dc} mesh, have "
            f"{len(devices)}")
    devs = np.array(list(devices)[:dr * dc]).reshape(dr, dc)
    return Mesh(devs, axis_names)


def shard_2d(tensor, dr: int, dc: int, index_dtype=jnp.int32,
             ) -> Sharded2DMatrix:
    """Host-side split into a (dr x dc) block grid (padded capacity = the
    largest block; permute power-law graphs first to balance)."""
    import numpy as np
    M, N = tensor.sparse_sizes()
    assert M % dr == 0 and N % dc == 0, (
        f"shape {(M, N)} must divide into a {(dr, dc)} grid")
    rb, cb = M // dr, N // dc
    row_np = np.asarray(tensor.storage.row())
    col_np = np.asarray(tensor.storage.col())
    value = tensor.storage.value()
    val_np = (np.asarray(value) if value is not None
              else np.ones(row_np.shape, np.float32))

    from .spmm import _bucket_fill
    bi = (row_np // rb).astype(np.int64)
    bj = (col_np // cb).astype(np.int64)
    order = np.lexsort((row_np, bj, bi))
    row_s, col_s, val_s = row_np[order], col_np[order], val_np[order]
    bi_s, bj_s = bi[order], bj[order]
    counts = np.zeros((dr, dc), np.int64)
    np.add.at(counts, (bi_s, bj_s), 1)
    C = max(1, int(counts.max()))

    rows, cols, vals = _bucket_fill(
        [(row_s - bi_s * rb).astype(np.int64),
         (col_s - bj_s * cb).astype(np.int64), val_s],
        bi_s * dc + bj_s, counts.ravel(), C, [rb, 0, 0])
    return Sharded2DMatrix(row=jnp.asarray(rows.reshape(dr, dc, C),
                                           index_dtype),
                           col=jnp.asarray(cols.reshape(dr, dc, C),
                                           index_dtype),
                           value=jnp.asarray(vals.reshape(dr, dc, C)),
                           shape=(M, N), grid=(dr, dc))


def device_put_2d(mesh: Mesh, mat: Sharded2DMatrix,
                  axes=("dr", "dc")) -> Sharded2DMatrix:
    sh = NamedSharding(mesh, P(axes[0], axes[1], None))
    return mat._replace(row=jax.device_put(mat.row, sh),
                        col=jax.device_put(mat.col, sh),
                        value=jax.device_put(mat.value, sh))


def spmm_2d(mesh: Mesh, mat: Sharded2DMatrix, x: jax.Array,
            axes=("dr", "dc"), reduce: str = "sum") -> jax.Array:
    """``A @ x`` on the 2-D grid.

    ``x``: (N, K) sharded ``P(dc, None)`` (rows split over column blocks,
    replicated over ``dr``).  Returns (M, K) sharded ``P((dr, dc), None)``
    — each device holds M/(Dr*Dc) fully-reduced output rows.  Only
    ``reduce='sum'`` distributes over the column-block partials.
    """
    if reduce not in ("sum", "add"):
        raise ValueError("spmm_2d supports reduce='sum' only")
    dr_name, dc_name = axes
    dr, dc = mat.grid
    rb = mat.shape[0] // dr
    assert rb % dc == 0, (
        f"row block {rb} must divide over {dc} devices for psum_scatter")

    def kernel(row, col, value, x_local):
        # local partial: my (rb, K) row block from my column block
        part = spmm_coo(row[0, 0], col[0, 0], value[0, 0], x_local[0],
                        rb + 1, "sum")[:rb]
        # sum partials across the column axis AND split the rows over it
        return jax.lax.psum_scatter(part, dc_name, scatter_dimension=0,
                                    tiled=True)[None]

    fn = shard_map(
        kernel, mesh=mesh,
        in_specs=(P(dr_name, dc_name, None), P(dr_name, dc_name, None),
                  P(dr_name, dc_name, None), P(dc_name, None, None)),
        out_specs=P(dr_name, dc_name, None), check_vma=False)
    # x enters as (N, K) sharded over dc: reshape to (dc, N/dc, K) blocks
    xb = x.reshape(dc, mat.shape[1] // dc, x.shape[-1])
    out = fn(mat.row, mat.col, mat.value, xb)
    # out: (dr, dc, rb/dc, K) device-local fully-reduced rows, in row order
    return out.reshape(mat.shape[0], x.shape[-1])