"""Jittable neighbor sampling and random walks.

Device replacement for the reference's sequential C++ sampler
(``/root/reference/csrc/cpu/sample_cpu.cpp``).  The C++ design (per-row loops,
hash-map relabeling, data-dependent output shapes) cannot compile to a
static-shape device program;
these kernels are fixed-fanout with static shapes:

* ``sample_neighbors``: per-row uniform draws (with replacement) —
  vectorized form of the reference's rand*rowcount trick
  (``paddle_sparse/sample.py:10-28``).
* ``sample_adj_padded``: GraphSAGE-style subgraph sampling.  Distinct
  (without-replacement) draws use priority sampling: one random priority per
  edge, a (row, priority) lexsort, and the first ``min(deg, fanout)`` slots
  of each row segment — the vectorized equivalent of the reference's
  Robert-Floyd loop (``sample_cpu.cpp:89-120``).  Relabeling is sort-based
  instead of the reference's ``std::unordered_map`` (``sample_cpu.cpp:33-60``)
  — a documented deviation: ``n_id`` is (seeds, then discovered nodes in
  ascending node order) rather than first-seen order; set-equality with the
  reference holds and the eager facade (``paddle_sparse_jax/sample.py``)
  reproduces first-seen order exactly.
* ``random_walk``: uniform walks via ``lax.scan``; zero-degree nodes
  self-loop (upstream pytorch_sparse semantics).
"""
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnums=(3,))
def sample_neighbors(rowptr: jax.Array, col: jax.Array, key: jax.Array,
                     num_neighbors: int, subset=None) -> jax.Array:
    """For each (subset) row, draw ``num_neighbors`` uniform neighbors with
    replacement.  Rows of degree 0 return whatever ``col[rowptr[r]]`` holds
    (reference semantics — callers mask by rowcount)."""
    starts = rowptr[:-1] if subset is None else rowptr[subset]
    ends = rowptr[1:] if subset is None else rowptr[jnp.asarray(subset) + 1]
    deg = (ends - starts).astype(jnp.float32)
    u = jax.random.uniform(key, (starts.shape[0], num_neighbors))
    offs = jnp.floor(u * deg[:, None]).astype(starts.dtype)
    return col[jnp.clip(starts[:, None] + offs, 0, col.shape[0] - 1)]


class PaddedAdj(NamedTuple):
    """Static-shape sampled subgraph (capacity = num_seeds * fanout)."""
    rowptr: jax.Array     # (num_seeds + 1,)
    col: jax.Array        # (capacity,) local node ids; -1 on padding
    e_id: jax.Array       # (capacity,) source edge positions; 0 on padding
    n_id: jax.Array       # (num_seeds + capacity,) global ids; sentinel pad
    num_nodes: jax.Array  # () valid prefix length of n_id
    num_edges: jax.Array  # () number of valid edges
    edge_mask: jax.Array  # (capacity,) bool validity


@partial(jax.jit, static_argnums=(3, 4))
def sample_adj_padded(rowptr: jax.Array, col: jax.Array, subset: jax.Array,
                      num_neighbors: int, replace: bool,
                      key: jax.Array) -> PaddedAdj:
    subset = jnp.asarray(subset)
    S = int(subset.shape[0])
    F = int(num_neighbors)
    cap = S * F
    idx_dtype = col.dtype
    nnz = int(col.shape[0])

    starts = rowptr[subset]
    deg = rowptr[subset + 1] - starts

    if replace:
        u = jax.random.uniform(key, (S, F))
        offs = jnp.floor(u * deg[:, None].astype(u.dtype)).astype(idx_dtype)
        counts = jnp.where(deg > 0, F, 0)
        gather_pos = jnp.clip(starts[:, None] + offs, 0, nnz - 1)
    else:
        # priority sampling: random priority per edge, stable-sort edges by
        # (row, priority); slot j of row r is then the j-th priority edge.
        edge_row = jnp.searchsorted(
            rowptr, jnp.arange(nnz, dtype=rowptr.dtype), side="right") - 1
        prio = jax.random.uniform(key, (nnz,))
        perm = jnp.lexsort((prio, edge_row))   # row-major, random within row
        counts = jnp.minimum(deg, F)
        slot = jnp.arange(F, dtype=idx_dtype)[None, :]
        gather_pos = perm[jnp.clip(starts[:, None] + slot, 0, max(nnz - 1, 0))]

    valid = (jnp.arange(F, dtype=deg.dtype)[None, :] < counts[:, None])
    flat_valid = valid.reshape(-1)
    e_id = jnp.where(flat_valid, gather_pos.reshape(-1), 0)
    flat_nodes = jnp.where(flat_valid, col[e_id], -1)
    seed_of = jnp.repeat(jnp.arange(S, dtype=idx_dtype), F)

    # ---- sort-based relabel -------------------------------------------
    in_subset_pos = _lookup_in_sorted(subset, flat_nodes)
    is_seed = in_subset_pos >= 0

    sentinel = jnp.asarray(jnp.iinfo(jnp.int32).max, idx_dtype)
    cand = jnp.where(flat_valid & ~is_seed, flat_nodes, sentinel)
    sorted_cand = jnp.sort(cand)
    uniq_mask = jnp.concatenate([
        (sorted_cand[:1] != sentinel),
        (sorted_cand[1:] != sorted_cand[:-1]) & (sorted_cand[1:] != sentinel),
    ])
    num_new = jnp.sum(uniq_mask)
    ranks = jnp.cumsum(uniq_mask) - 1
    # compact unique candidates to the front, pad tail with sentinel
    compact = jnp.full((cap,), sentinel, idx_dtype)
    compact = compact.at[jnp.where(uniq_mask, ranks, cap)].set(
        sorted_cand, mode="drop")

    n_id = jnp.concatenate([subset.astype(idx_dtype), compact])
    num_nodes = S + num_new

    pos_in_compact = jnp.searchsorted(compact, flat_nodes)
    local = jnp.where(is_seed, in_subset_pos.astype(idx_dtype),
                      (S + pos_in_compact).astype(idx_dtype))
    local = jnp.where(flat_valid, local, jnp.asarray(-1, idx_dtype))

    # ---- compact valid entries to the front, sorted by (seed, local) --
    # (so that row r's edges occupy rowptr[r]:rowptr[r+1], with per-row
    # cols sorted — the reference's output layout, sample_cpu.cpp:132-145)
    big = jnp.asarray(2 * (cap + S) + 2, idx_dtype)
    sort_key = jnp.where(flat_valid, seed_of * big + local,
                         jnp.asarray(big * (S + 1), idx_dtype))
    order = jnp.argsort(sort_key)
    local = local[order]
    e_id = jnp.where(flat_valid[order], e_id[order], 0)
    edge_mask = flat_valid[order]

    out_rowptr = jnp.concatenate([
        jnp.zeros((1,), idx_dtype),
        jnp.cumsum(counts).astype(idx_dtype)])

    return PaddedAdj(rowptr=out_rowptr, col=local, e_id=e_id, n_id=n_id,
                     num_nodes=num_nodes.astype(idx_dtype),
                     num_edges=jnp.sum(counts).astype(idx_dtype),
                     edge_mask=edge_mask)


def _lookup_in_sorted(table: jax.Array, queries: jax.Array) -> jax.Array:
    """Position of each query in ``table`` (unique entries), else -1."""
    order = jnp.argsort(table)
    sorted_t = table[order]
    pos = jnp.clip(jnp.searchsorted(sorted_t, queries), 0,
                   table.shape[0] - 1)
    hit = sorted_t[pos] == queries
    return jnp.where(hit, order[pos], -1)


@partial(jax.jit, static_argnums=(3,))
def random_walk(rowptr: jax.Array, col: jax.Array, start: jax.Array,
                walk_length: int, key: jax.Array) -> jax.Array:
    """Uniform random walks: (num_start, walk_length + 1) node ids.

    Matches upstream ``torch_sparse.random_walk`` semantics: zero-degree
    nodes repeat themselves.
    """
    start = jnp.asarray(start)
    n = start.shape[0]
    u = jax.random.uniform(key, (walk_length, n))

    def step(cur, u_t):
        lo = rowptr[cur]
        deg = rowptr[cur + 1] - lo
        off = jnp.floor(u_t * deg.astype(u_t.dtype)).astype(cur.dtype)
        pos = jnp.clip(lo + off, 0, col.shape[0] - 1)
        nxt = jnp.where(deg > 0, col[pos], cur)
        return nxt, nxt

    _, walks = jax.lax.scan(step, start, u)
    return jnp.concatenate([start[None], walks], axis=0).T
