"""SELL-style padded-group SpMM (an explicit alternative path).

Instead of materializing the scaled product stream ``take(x, col) *
value``, every row's edge list is padded to groups of ``G`` and each
group's ``G`` row gathers are summed elementwise, which XLA fuses into a
single pass; only the per-group partials are written.

Design:

1. **Plan (static, per sparse structure)**: pad every row's edge list to a
   multiple of ``G`` (default 32) — a SELL/ELLPACK-slice layout — and
   store the slot grid TRANSPOSED as ``(G, groups)``: slot ``(i, g)``
   holds padded-stream position ``g*G + i``.  Pad slots carry column
   sentinel ``N`` (gather-clipped, masked by a zero value).
2. **Values live in the same (G, groups) grid** (``pad_values`` converts
   a COO-ordered (nnz,) vector once; training code keeps the grid as the
   differentiated leaf, exactly like CSR keeps values in CSR order).
3. **Level-1 reduce (XLA, fused)**: ``partials[g] = sum_{i<G}
   val[i, g] * x[col[i, g]]`` — G row gathers summed elementwise, fused
   by XLA into a single pass: HBM traffic is the x-row reads plus a
   ``groups``-sized partial write (1/G of the stream).
4. **Level-2 reduce**: group partials are segment-reduced to output rows
   by the fused kernel's materialised-stream mode
   (``kernels/spmm_pallas.py``) on the GPU; plain sorted segment-sum on
   the CPU.

Processing runs in row-aligned blocks (``lax.map``) sized by the plan so
per-block buffers stay bounded at ogbn-products scale.

Autograd (value and x only, reference semantics /root/reference/README.md:96):
``d_x = A^T @ g`` reuses the same path over the plan's transpose
structure, with the value grid re-laid out through a static plan-time
slot map; ``d_value`` is a fused SDDMM in the same grid layout (or a
chunked COO SDDMM when the caller passed a 1-D value).

The reference has no SpMM (unsupported list, /root/reference/README.md:45);
the functional contract is upstream's, /root/reference/README.md:267-300.
"""
import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .kernels.spmm_pallas import interpret_mode
import numpy as np

from .convert import ind2ptr


class SellStructure(NamedTuple):
    """Device-resident padded-group index structure (and its transpose).

    Passed to jitted code as ARGUMENTS, never closed over, so large index
    arrays do not become constants of the compiled program.
    """
    col_T: jax.Array      # (G, ng) column per slot, N = pad sentinel
    gptr: jax.Array       # (M + 1,) CSR pointer in GROUP units
    grow: jax.Array       # (ng,) global output row of each group
    eid: jax.Array        # (ng * G,) edge id per padded slot, -1 = pad
    row: jax.Array        # (nnz,) original sorted COO rows (for SDDMM)
    col: jax.Array        # (nnz,) original COO cols
    # transpose (A^T) structure for the d_x backward
    col_Tt: jax.Array     # (G, ng_t)
    gptr_t: jax.Array     # (N + 1,)
    vmap_t: jax.Array     # (G, ng_t) flat fwd-grid slot per A^T slot;
    #                       sentinel ng*G on pads (maps to a zero cell)
    perm_t: jax.Array     # (nnz,) csr->csc permutation


class SellPlan(NamedTuple):
    """Static (hashable) geometry for :func:`spmm_sell`."""
    num_rows: int
    num_cols: int
    group: int
    group_capacity: int     # max groups per row block
    rows_per_block: int
    group_capacity_t: int
    rows_per_block_t: int
    interpret: bool = False
    l2_backend: str = "pallas"   # "pallas" | "xla" (CPU/tests)
    l2_identity: bool = False    # every row has exactly one group
    l2_identity_t: bool = False


@functools.partial(jax.jit, static_argnames=("num_rows", "group"))
def _sell_geometry(row, *, num_rows: int, group: int):
    """rowptr + per-row group pointer for one orientation (one jit call,
    not one dispatch per op)."""
    rowptr = ind2ptr(row, num_rows).astype(jnp.int32)
    deg = rowptr[1:] - rowptr[:-1]
    groups = -(-deg // group)                       # ceil
    gptr = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                            jnp.cumsum(groups).astype(jnp.int32)])
    gmax = groups.max() if num_rows > 0 else jnp.int32(0)
    return rowptr, gptr, gmax


@functools.partial(jax.jit,
                   static_argnames=("ngroups", "group", "num_rows",
                                    "num_cols"))
def _sell_slots(rowptr, gptr, col, *, ngroups: int, group: int,
                num_rows: int, num_cols: int):
    """Padded slot arrays: linear eid stream, transposed column grid and
    the group -> row map.

    Works at (ngroups, G) granularity: the only searchsorted is the
    group -> row map (ngroups queries, G-fold smaller than a per-slot
    search).
    """
    deg = rowptr[1:] - rowptr[:-1]
    grow = jnp.clip(
        jnp.searchsorted(gptr, jnp.arange(ngroups, dtype=jnp.int32),
                         side="right") - 1,
        0, max(num_rows - 1, 0)).astype(jnp.int32)
    g_ids = jnp.arange(ngroups, dtype=jnp.int32)
    i_ids = jnp.arange(group, dtype=jnp.int32)
    # slot (g, i): offset inside its row = (g - first group of row)*G + i
    within = ((g_ids - jnp.take(gptr, grow, mode="clip"))[:, None] * group
              + i_ids[None, :])
    valid = within < jnp.take(deg, grow, mode="clip")[:, None]
    eid2d = jnp.where(
        valid, jnp.take(rowptr, grow, mode="clip")[:, None] + within,
        -1).astype(jnp.int32)
    col2d = jnp.where(valid,
                      jnp.take(col, jnp.clip(eid2d, 0), mode="clip"),
                      num_cols).astype(jnp.int32)
    # slot (i, g) of col_T holds padded-stream position g*G + i
    col_T = col2d.T
    eid = eid2d.reshape(-1)
    return eid, col_T, grow


@jax.jit
def _csc_view(row, col):
    perm_t = jnp.argsort(col, stable=True).astype(jnp.int32)
    return perm_t, jnp.take(col, perm_t), jnp.take(row, perm_t)


@functools.partial(jax.jit, static_argnames=("num_rows", "candidates"))
def _padded_slot_counts(row, *, num_rows: int, candidates: tuple):
    """Total padded slots for each candidate group width (one jit call)."""
    rowptr = ind2ptr(row, num_rows).astype(jnp.int32)
    deg = rowptr[1:] - rowptr[:-1]
    return jnp.stack([(-(-deg // g) * g).sum() for g in candidates])


def _pick_group(row, num_rows: int, nnz: int) -> int:
    """SELL-sigma-style adaptive slice width: choose the group G (>= 32,
    where XLA fuses the unrolled gather sum) minimizing padded slots.

    Near-regular graphs (the ogbn bench family) land on G ~ mean degree:
    zero padding AND one group per row, which collapses level 2 to the
    identity.  Skewed graphs fall back toward 32.
    """
    mean_deg = max(1, nnz // max(num_rows, 1))
    cands = sorted({32, 48, 64, min(256, max(32, mean_deg)),
                    min(256, max(32, -(-mean_deg // 8) * 8))})
    totals = _padded_slot_counts(row, num_rows=num_rows,
                                 candidates=tuple(cands))
    return int(cands[int(jnp.argmin(totals))])


@functools.partial(jax.jit, static_argnames=("nnz", "group", "ng"))
def _fwd_slot_map(eid, perm_t, eid_t, *, nnz: int, group: int, ng: int):
    """(G, ng_t) flat fwd-grid slot of each A^T slot (static plan data).

    Flat fwd-grid index of slot (i, g) is ``i * ng + g`` (the row-major
    ravel of the (G, ng) grid).  Pads map to the sentinel ``G * ng``
    (callers append one zero cell)."""
    slots = eid.shape[0]
    p = jnp.arange(slots, dtype=jnp.int32)
    flat = (p % group) * ng + p // group
    # pads route to index nnz, which mode="drop" discards
    inv_slot = jnp.zeros((nnz,), jnp.int32).at[
        jnp.where(eid >= 0, eid, nnz)].set(flat, mode="drop")
    ng_t = eid_t.shape[0] // group
    orig_edge = jnp.where(eid_t >= 0,
                          jnp.take(perm_t, jnp.clip(eid_t, 0),
                                   mode="clip"), 0)
    vmap = jnp.where(eid_t >= 0,
                     jnp.take(inv_slot, orig_edge, mode="clip"),
                     group * ng).astype(jnp.int32)
    return vmap.reshape(ng_t, group).T


def _sell_pad(row, col, num_rows: int, num_cols: int, group: int):
    """Padded-slot construction for one orientation (two jit calls + one
    scalar host pull for the static group count)."""
    rowptr, gptr, gmax = _sell_geometry(row, num_rows=num_rows,
                                        group=group)
    ngroups = max(int(gptr[-1]), 1)
    # identity level-2: every row contributes exactly one group, so group
    # partials ARE the output rows and level 2 can be skipped entirely
    identity = (ngroups == num_rows) and int(gmax) == 1
    eid, col_T, grow = _sell_slots(rowptr, gptr, col, ngroups=ngroups,
                                   group=group, num_rows=num_rows,
                                   num_cols=num_cols)
    return eid, col_T, grow, gptr, identity


def _plan_blocks(gptr_host, feat_dim: int, target_bytes: int):
    """Row-aligned blocks with bounded group count.

    Equal row blocks; capacity = max groups over blocks (skewed degree
    distributions inflate it — pass smaller target_bytes for power-law
    graphs, or pre-sort rows by degree).
    """
    gp = np.asarray(gptr_host, dtype=np.int64)
    num_rows = gp.shape[0] - 1
    total_groups = max(int(gp[-1]), 1)

    def cdiv(a, b):
        return -(-a // b)

    budget_groups = max(128, target_bytes // max(1, feat_dim * 4))
    nblocks = max(1, cdiv(total_groups, budget_groups))
    CB = max(1, cdiv(num_rows, nblocks))
    # tile-align rows per block for the level-2 kernel's 128-row tiles
    CB = cdiv(CB, 128) * 128
    nblocks = cdiv(num_rows, CB)
    bounds = gp[np.minimum(np.arange(nblocks + 1) * CB, num_rows)]
    max_groups = int(np.max(np.diff(bounds))) if nblocks else 1
    GC = max(8, cdiv(max_groups, 8) * 8)
    return CB, GC, nblocks


def make_sell_plan(row, col, num_rows: int, num_cols: int, *,
                   group="auto", feat_dim: int = 256,
                   target_bytes: int = 120 * 1024 * 1024,
                   l2_backend: Optional[str] = None):
    """Host-side setup: build the padded-group structure (both
    orientations) and the row-block geometry.  Eager — needs concrete
    indices.  Returns ``(plan, structure)`` for :func:`spmm_sell`.

    ``group``: pad quantum; "auto" (default) picks the width minimizing
    padded slots (>= 32 — XLA fuses the gather sum from 32 operands up).
    """
    row = jnp.asarray(row, dtype=jnp.int32)
    col = jnp.asarray(col, dtype=jnp.int32)
    nnz = int(row.shape[0])
    if group == "auto":
        group = (_pick_group(row, num_rows, nnz)
                 if jax.default_backend() != "cpu" else 8)

    eid, col_T, grow, gptr, ident = _sell_pad(row, col, num_rows,
                                              num_cols, group)
    perm_t, row_t, col_t = _csc_view(row, col)
    eid_t, col_Tt, _, gptr_t, ident_t = _sell_pad(row_t, col_t, num_cols,
                                                  num_rows, group)
    ng = col_T.shape[1]
    vmap_t = _fwd_slot_map(eid, perm_t, eid_t, nnz=max(nnz, 1),
                           group=group, ng=ng)

    CB, GC, _ = _plan_blocks(np.asarray(gptr), feat_dim, target_bytes)
    CBT, GCT, _ = _plan_blocks(np.asarray(gptr_t), feat_dim, target_bytes)
    on_cpu = interpret_mode()
    if l2_backend is None:
        l2_backend = "xla" if on_cpu else "pallas"
    plan = SellPlan(num_rows, num_cols, group, GC, CB, GCT, CBT,
                    interpret=on_cpu, l2_backend=l2_backend,
                    l2_identity=ident, l2_identity_t=ident_t)
    structure = SellStructure(col_T, gptr, grow, eid, row, col,
                              col_Tt, gptr_t, vmap_t, perm_t)
    return plan, structure


@functools.partial(jax.jit, static_argnames=("group",))
def pad_values(s: SellStructure, value: jax.Array, *, group: int):
    """COO-ordered (nnz,) values -> the format's (G, ng) grid (pads = 0).

    One near-monotone gather; do this ONCE when building the operand (and
    keep the grid as the autograd leaf) rather than per call."""
    v = jnp.where(s.eid >= 0,
                  jnp.take(value, jnp.clip(s.eid, 0), mode="clip"),
                  jnp.zeros((), value.dtype))
    return v.reshape(-1, group).T


@functools.partial(jax.jit, static_argnames=("group",))
def unpad_values(s: SellStructure, grid: jax.Array, *, group: int):
    """(G, ng) grid -> COO-ordered (nnz,) values (inverse of
    :func:`pad_values` on real slots)."""
    flat = grid.T.reshape(-1)
    nnz = s.row.shape[0]
    slots = s.eid.shape[0]
    pos = jnp.zeros((nnz,), jnp.int32).at[
        jnp.where(s.eid >= 0, s.eid, nnz)].set(
        jnp.arange(slots, dtype=jnp.int32), mode="drop")
    return jnp.take(flat, pos, mode="clip")


def _level2(partials, gp_local, num_rows_block, interpret, l2_backend):
    """Reduce group partials to rows: the fused kernel on the GPU,
    plain sorted segment-sum elsewhere (tiny shapes in tests)."""
    if l2_backend == "pallas":
        from .kernels.spmm_pallas import segment_rows_matmul
        return segment_rows_matmul(partials, None, gp_local,
                                   num_rows_block, interpret=interpret)
    ngroups = partials.shape[0]
    grow = jnp.clip(
        jnp.searchsorted(gp_local, jnp.arange(ngroups, dtype=jnp.int32),
                         side="right") - 1, 0, num_rows_block - 1)
    return jax.ops.segment_sum(partials, grow,
                               num_segments=num_rows_block,
                               indices_are_sorted=True)


@functools.partial(jax.jit, static_argnames=("plan", "transpose"))
def _spmm_sell_fwd_oriented(plan: SellPlan, col_T, gptr, val_grid, x,
                            *, transpose: bool = False):
    """Blocked fused forward over one orientation's padded structure.

    ``val_grid``: (G, ng) value grid for this orientation, or None for
    implicit ones (structural adjacency).
    """
    if transpose:
        M = plan.num_cols
        CB, GC = plan.rows_per_block_t, plan.group_capacity_t
        identity = plan.l2_identity_t
    else:
        M = plan.num_rows
        CB, GC = plan.rows_per_block, plan.group_capacity
        identity = plan.l2_identity
    G = plan.group
    K = x.shape[1]
    nblocks = -(-M // CB)
    acc_dtype = jnp.promote_types(x.dtype, jnp.float32)

    # pad streams so every dynamic_slice window is in range
    col_pad = jnp.concatenate(
        [col_T, jnp.full((G, GC), x.shape[0], jnp.int32)], axis=1)
    if val_grid is not None:
        val_pad = jnp.concatenate(
            [val_grid, jnp.zeros((G, GC), val_grid.dtype)], axis=1)
    gptr_pad = jnp.concatenate(
        [gptr, jnp.full((nblocks * CB + 1 - gptr.shape[0],),
                        gptr[-1], jnp.int32)])
    grp_off = jnp.arange(CB + 1, dtype=jnp.int32)

    def block_fn(b):
        r0 = b * CB
        gp_l = jnp.take(gptr_pad, r0 + grp_off, mode="clip")
        g0 = gp_l[0]
        gp_l = jnp.clip(gp_l - g0, 0, GC)
        cols = jax.lax.dynamic_slice(col_pad, (jnp.int32(0), g0), (G, GC))
        if val_grid is not None:
            vals = jax.lax.dynamic_slice(val_pad, (jnp.int32(0), g0),
                                         (G, GC))
        # fused level-1: G row gathers summed elementwise — the (GC*G, K)
        # product is a fusion temporary, never an HBM buffer
        out = jnp.zeros((GC, K), acc_dtype)
        for i in range(G):
            if val_grid is None:
                v = (cols[i] < x.shape[0]).astype(acc_dtype)
            else:
                v = vals[i].astype(acc_dtype)
            out = out + jnp.take(x, cols[i], axis=0,
                                 mode="clip").astype(acc_dtype) * (
                v[:, None])
        if identity:
            # one group per row: the partials ARE the output rows
            out_b = (out[:CB] if GC >= CB
                     else jnp.pad(out, ((0, CB - GC), (0, 0))))
        else:
            out_b = _level2(out, gp_l, CB, plan.interpret,
                            plan.l2_backend)
        return out_b.astype(acc_dtype)

    out = jax.lax.map(block_fn, jnp.arange(nblocks, dtype=jnp.int32))
    return out.reshape(nblocks * CB, K)[:M]


@functools.partial(jax.jit, static_argnames=("plan",))
def _sddmm_grid(plan: SellPlan, col_T, grow, g_out, x):
    """d_value in grid layout: dv[i, g] = g_out[grow[g]] . x[col_T[i, g]]
    for real slots (pads read clipped rows but are re-zeroed by the
    caller's mask or simply never read back).  Blocked like the forward.
    """
    G = plan.group
    CB, GC = plan.rows_per_block, plan.group_capacity
    M = plan.num_rows
    K = x.shape[1]
    nblocks = -(-M // CB)
    ng = col_T.shape[1]
    acc_dtype = jnp.promote_types(x.dtype, jnp.float32)

    col_pad = jnp.concatenate(
        [col_T, jnp.full((G, GC), x.shape[0], jnp.int32)], axis=1)
    grow_pad = jnp.concatenate([grow, jnp.full((GC,), M, jnp.int32)])
    # block b covers the contiguous group range of rows [b*CB, (b+1)*CB)
    gb = jnp.searchsorted(grow, jnp.arange(nblocks + 1, dtype=jnp.int32)
                          * CB, side="left").astype(jnp.int32)

    def block_fn(b):
        g0 = gb[b]
        cols = jax.lax.dynamic_slice(col_pad, (jnp.int32(0), g0), (G, GC))
        grows = jax.lax.dynamic_slice(grow_pad, (g0,), (GC,))
        valid_g = grows < jnp.minimum((b + 1) * CB, M)
        g_rows = jnp.take(g_out, jnp.clip(grows, 0, M - 1), axis=0,
                          mode="clip").astype(acc_dtype)
        g_rows = g_rows * valid_g[:, None]
        dv = []
        for i in range(G):
            xi = jnp.take(x, cols[i], axis=0,
                          mode="clip").astype(acc_dtype)
            dv.append(jnp.sum(g_rows * xi, axis=1)
                      * (cols[i] < x.shape[0]))
        return jnp.stack(dv)                     # (G, GC)

    dv = jax.lax.map(block_fn, jnp.arange(nblocks, dtype=jnp.int32))

    # blocks cover contiguous group ranges in increasing order; later
    # blocks overwrite the masked-zero tails of earlier windows
    def paste(b, out):
        blk = jax.lax.dynamic_index_in_dim(dv, b, keepdims=False)
        return jax.lax.dynamic_update_slice(out, blk, (jnp.int32(0),
                                                       gb[b]))

    out = jax.lax.fori_loop(0, nblocks, paste,
                            jnp.zeros((plan.group, ng + GC), acc_dtype))
    return out[:, :ng]


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def spmm_sell(plan: SellPlan, s: SellStructure,
              value: Optional[jax.Array], x: jax.Array) -> jax.Array:
    """``A @ x`` (sum reduction) over a padded-group plan; differentiable
    in ``(value, x)``.

    ``value``: None (structural ones), a COO-ordered (nnz,) vector
    (converted on the fly — prefer converting once via
    :func:`pad_values`), or the format-native (G, ng) grid.  Output dtype
    follows ``x``; accumulation is f32 (f64 when inputs are f64)."""
    grid = _as_grid(plan, s, value)
    out = _spmm_sell_fwd_oriented(plan, s.col_T, s.gptr, grid, x)
    return out.astype(x.dtype)


def _as_grid(plan, s, value):
    if value is None:
        return None
    if value.ndim == 1:
        return pad_values(s, value, group=plan.group)
    return value


def _grid_to_transpose(plan, s, grid):
    """Re-lay the forward value grid into the A^T grid via the static
    slot map (one gather per backward call)."""
    # flat index convention of _fwd_slot_map is i * ng + g == the ravel of
    # the (G, ng) grid itself; one extra zero cell backs the pad sentinel
    flat = jnp.concatenate([grid.reshape(-1),
                            jnp.zeros((1,), grid.dtype)])
    out = jnp.take(flat, s.vmap_t, mode="clip")
    # materialize: without the barrier XLA fuses this gather as a producer
    # into every one of the G row gathers of the transpose pass, which
    # stops them from fusing into one streaming sum (the d_x pass would
    # then materialize G (ng_t, K) temporaries)
    return jax.lax.optimization_barrier(out)


def _spmm_sell_fwd(plan, s, value, x):
    return spmm_sell(plan, s, value, x), (s, value, x)


def _spmm_sell_bwd(plan, res, g):
    s, value, x = res
    if value is None:
        d_value = None
        grid_t = None
    else:
        grid = _as_grid(plan, s, value)
        grid_t = _grid_to_transpose(plan, s, grid)
        if value.ndim == 1:
            from .kernels.spmm_pallas import sddmm_dot_chunked
            d_value = sddmm_dot_chunked(s.row, s.col, g, x,
                                        out_dtype=value.dtype)
        else:
            d_value = _sddmm_grid(plan, s.col_T, s.grow, g,
                                  x).astype(value.dtype)
    d_x = _spmm_sell_fwd_oriented(plan, s.col_Tt, s.gptr_t, grid_t, g,
                                  transpose=True)
    d_s = jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, jax.dtypes.float0), s)
    return d_s, d_value, d_x.astype(x.dtype)


spmm_sell.defvjp(_spmm_sell_fwd, _spmm_sell_bwd)