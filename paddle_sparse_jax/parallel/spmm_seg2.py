"""Row-sharded seg2 SpMM under ``shard_map``.

The planned seg2 path needs concrete indices at plan time, so the
per-shard plans are built on the host from the concrete sharded
structure (``jax.vmap`` of the seg2 phase builders over the device
axis), the static geometry is made uniform across shards, and the
stacked :class:`Seg2Structure` leaves are sharded over the mesh — inside
``shard_map`` every device runs the exact :func:`ops.spmm_seg2.spmm_seg2`
it runs on one card.

Strategy: 1-D row sharding with one ``all_gather`` of the dense operand
(the halo/ring variants in ``parallel/spmm.py`` remain available for
bandwidth-bound regimes).  Differentiable in ``(packed_value, x)``: the
all-gather transposes to a ``psum_scatter``.
"""
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.kernels.spmm_pallas import interpret_mode
from ..ops.spmm_seg2 import (SRC_SLICE_BYTES, Seg2Plan, Seg2Structure,
                             _build_fwd, _build_t, _pick_sr, _relays,
                             spmm_seg2)
from .spmm import RowShardedMatrix


class ShardedSeg2(NamedTuple):
    """Uniform-static plan + device-stacked structure (leading axis D)."""
    plan: Seg2Plan
    structure: Seg2Structure


def make_seg2_plan_sharded(mat: RowShardedMatrix, *, feat_dim: int,
                           stream=None, sr=None,
                           slice_bytes=SRC_SLICE_BYTES) -> ShardedSeg2:
    """Build per-shard seg2 plans with shard-uniform static geometry.

    Local row space per shard = ``rows_per_shard + 1`` (the extra dead
    row absorbs padding, exactly as the single-card padded contract)."""
    import functools

    from ..ops.kernels.spmm_pallas import _stream_env

    stream = stream or _stream_env()
    stream_bytes = 2 if stream == "bf16" else 4

    M_local = mat.rows_per_shard + 1
    N = mat.shape[1]

    SR = sr or _pick_sr(N, feat_dim, stream_bytes, slice_bytes)
    # non-pow2 SR makes seg = col >> lg2(SR) drop edges silently
    assert SR & (SR - 1) == 0, "segment size must be a power of two"
    S = max(1, -(-N // SR))
    SR_t = sr or _pick_sr(M_local, feat_dim, stream_bytes, slice_bytes)
    S_t = max(1, -(-M_local // SR_t))

    rows = jnp.asarray(mat.row, jnp.int32)
    # padding cols are N (one past the end): clamp into the last segment
    # — their values are zero and their rows are the dead row, so they
    # contribute nothing either way
    cols = jnp.clip(jnp.asarray(mat.col, jnp.int32), 0, N - 1)

    bf = jax.vmap(functools.partial(_build_fwd, S=S, SR=SR, M=M_local))
    order_f, col_f, rp_f, ok = bf(rows, cols)
    if not bool(ok.all()):
        raise ValueError("sharded rows must be locally sorted ascending")
    bt = jax.vmap(functools.partial(_build_t, S_t=S_t, SR_t=SR_t, N=N))
    perm_t, col_t, rp_t = bt(rows, cols)

    plan = Seg2Plan(M_local, N, S, SR, S_t, SR_t,
                    interpret=interpret_mode(), stream=stream)
    structure = Seg2Structure(
        col_f=col_f, rp_f=rp_f, perm_f=order_f, col_t=col_t, rp_t=rp_t,
        relay_ft=jax.vmap(_relays)(order_f, perm_t),
        row_f=jnp.take_along_axis(rows, order_f, axis=1))
    return ShardedSeg2(plan=plan, structure=structure)


def pack_values_sharded(sharded: ShardedSeg2,
                        value: jax.Array) -> jax.Array:
    """(D, C) COO-ordered per-shard values -> the fwd packed layout."""
    return jnp.take_along_axis(value, sharded.structure.perm_f, axis=1)


def device_put_sharded_seg2(mesh: Mesh, sharded: ShardedSeg2,
                            axis_name: str = "x") -> ShardedSeg2:
    """Lay every structure leaf's device axis over the mesh."""
    def put(leaf):
        spec = P(axis_name, *([None] * (leaf.ndim - 1)))
        return jax.device_put(leaf, NamedSharding(mesh, spec))

    return ShardedSeg2(
        plan=sharded.plan,
        structure=jax.tree_util.tree_map(put, sharded.structure))


def spmm_seg2_allgather(mesh: Mesh, sharded: ShardedSeg2,
                        packed_value, x: jax.Array,
                        axis_name: str = "x") -> jax.Array:
    """Distributed SpMM: all-gather x over the mesh, then the exact
    single-card seg2 kernel path per shard.  ``x`` is row-sharded
    (N/D, K); returns row-sharded output blocks (D, rows_per_shard, K).

    Differentiable in ``(packed_value, x)``."""
    plan = sharded.plan
    rows_per = plan.num_rows - 1

    spec_struct = jax.tree_util.tree_map(
        lambda a: P(axis_name, *([None] * (a.ndim - 1))),
        sharded.structure)
    spec_blk = P(axis_name, None)
    spec3 = P(axis_name, None, None)

    if packed_value is not None:
        def kernel(struct, pv, x_local):
            local = jax.tree_util.tree_map(lambda a: a[0], struct)
            x_full = jax.lax.all_gather(x_local, axis_name, axis=0,
                                        tiled=True)
            out = spmm_seg2(plan, local, pv[0], x_full)
            return out[None, :rows_per]   # drop the padding dead row

        # check_vma=False: the Pallas call inside cannot declare
        # varying-mesh-axes metadata on its out_shape
        fn = shard_map(kernel, mesh=mesh,
                       in_specs=(spec_struct, spec_blk, spec_blk),
                       out_specs=spec3, check_vma=False)
        return fn(sharded.structure, packed_value, x)

    def kernel_nv(struct, x_local):
        local = jax.tree_util.tree_map(lambda a: a[0], struct)
        x_full = jax.lax.all_gather(x_local, axis_name, axis=0,
                                    tiled=True)
        out = spmm_seg2(plan, local, None, x_full)
        return out[None, :rows_per]

    fn = shard_map(kernel_nv, mesh=mesh,
                   in_specs=(spec_struct, spec_blk),
                   out_specs=spec3, check_vma=False)
    return fn(sharded.structure, x)


# ---------------------------------------------------------------------------
# seg2 x halo interchange: the seg2 path under the deduplicated
# all_to_all halo exchange.  The halo plan's remapped (local row,
# halo-buffer col) grid is exactly a RowShardedMatrix over an N = D*H
# column space, so the per-shard seg2 planner applies unchanged.
# ---------------------------------------------------------------------------
def make_seg2_halo_plan(halo_mat, *, feat_dim: int, stream=None, sr=None,
                        slice_bytes=SRC_SLICE_BYTES) -> ShardedSeg2:
    """Per-shard seg2 plans over a :class:`~.spmm.HaloShardedMatrix`'s
    halo-buffer column space (N = D * halo_per_src)."""
    D = int(halo_mat.row.shape[0])
    facade = RowShardedMatrix(
        row=halo_mat.row, col=halo_mat.col, value=halo_mat.value,
        nnz=None, shape=(halo_mat.shape[0], D * halo_mat.halo_per_src),
        rows_per_shard=halo_mat.rows_per_shard)
    return make_seg2_plan_sharded(facade, feat_dim=feat_dim,
                                  stream=stream, sr=sr,
                                  slice_bytes=slice_bytes)


def spmm_seg2_halo(mesh: Mesh, halo_mat, sharded: ShardedSeg2,
                   packed_value, x: jax.Array,
                   axis_name: str = "x") -> jax.Array:
    """Distributed SpMM: all_to_all of exactly the deduplicated halo
    rows (O(unique cols * K) interchange), then the exact single-chip
    seg2 kernel path per shard over the received halo buffer.

    ``x`` is row-sharded (N/D, K); returns row-sharded output blocks
    (D, rows_per_shard, K).  Differentiable in ``(packed_value, x)``
    (all_to_all and take have transposes)."""
    plan = sharded.plan
    rows_per = plan.num_rows - 1

    spec_struct = jax.tree_util.tree_map(
        lambda a: P(axis_name, *([None] * (a.ndim - 1))),
        sharded.structure)
    spec_blk = P(axis_name, None)
    spec3 = P(axis_name, None, None)

    def kernel(struct, send_idx, pv, x_local):
        local = jax.tree_util.tree_map(lambda a: a[0], struct)
        x_send = jnp.take(x_local, send_idx[0], axis=0, mode="clip")
        halo = jax.lax.all_to_all(x_send, axis_name, split_axis=0,
                                  concat_axis=0, tiled=False)
        halo = halo.reshape(-1, x_local.shape[-1])        # (D*H, K)
        out = spmm_seg2(plan, local, pv[0] if pv is not None else None,
                        halo)
        return out[None, :rows_per]

    if packed_value is not None:
        fn = shard_map(kernel, mesh=mesh,
                       in_specs=(spec_struct, spec3, spec_blk, spec_blk),
                       out_specs=spec3, check_vma=False)
        return fn(sharded.structure, halo_mat.send_idx, packed_value, x)

    def kernel_nv(struct, send_idx, x_local):
        return kernel(struct, send_idx, None, x_local)

    fn = shard_map(kernel_nv, mesh=mesh,
                   in_specs=(spec_struct, spec3, spec_blk),
                   out_specs=spec3, check_vma=False)
    return fn(sharded.structure, halo_mat.send_idx, x)
