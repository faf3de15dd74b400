"""PaddedCOO — the static-shape sparse matrix pytree for jitted compute.

This is the jit-side counterpart of the eager ``SparseStorage`` facade and
the central design decision (SURVEY.md §7 design note 1): the
reference mutates array lengths freely (coalesce shrinks, sampling emits
data-dependent shapes), which XLA cannot compile.  Here every matrix carries:

* ``row``/``col``/``value`` padded to a static ``capacity``; padding entries
  are ``(row=M, col=N, value=0)`` so they (a) sort after every real entry,
  (b) reduce into a dead row slot that kernels slice off, and (c) contribute
  zero to products.
* a traced scalar ``nnz`` counting real entries.
* static ``shape`` metadata.

Ops that change nnz (``coalesce``) keep capacity and update ``nnz``;
shrinking the buffers (``compact``) is an explicit host-sync point done on
the eager side.  The pytree registration makes PaddedCOO a first-class jit /
shard_map / grad citizen, and doubles as the checkpoint format (leaves +
static aux data serialize with orbax/np.savez — the persistence story the
reference lacks, SURVEY.md §5).
"""
import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..ops.convert import ind2ptr
from ..ops.spmm import spmm_coo


@partial(jax.tree_util.register_dataclass,
         data_fields=("row", "col", "value", "nnz"),
         meta_fields=("shape",))
@dataclasses.dataclass(frozen=True)
class PaddedCOO:
    row: jax.Array                 # (capacity,) int, sorted; padding = M
    col: jax.Array                 # (capacity,) int; padding = N
    value: Optional[jax.Array]     # (capacity,) or None; padding = 0
    nnz: jax.Array                 # () int32 — number of real entries
    shape: Tuple[int, int]         # static (M, N)

    # ------------------------------------------------------------------
    @property
    def capacity(self) -> int:
        return int(self.row.shape[0])

    @property
    def M(self) -> int:
        return self.shape[0]

    @property
    def N(self) -> int:
        return self.shape[1]

    def valid_mask(self) -> jax.Array:
        return self.row < self.M

    def rowptr(self) -> jax.Array:
        """CSR pointer over the M real rows (padding sorts into slot M)."""
        return ind2ptr(self.row, self.M)

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @classmethod
    def from_arrays(cls, row, col, value, shape: Tuple[int, int],
                    capacity: Optional[int] = None,
                    index_dtype=jnp.int32) -> "PaddedCOO":
        """Build from exact (eager) row-sorted COO arrays, padding to
        ``capacity`` (defaults to the exact nnz)."""
        row = jnp.asarray(row, dtype=index_dtype)
        col = jnp.asarray(col, dtype=index_dtype)
        n = int(row.shape[0])
        cap = n if capacity is None else int(capacity)
        assert cap >= n, "capacity must cover all entries"
        M, N = int(shape[0]), int(shape[1])

        pad = cap - n
        row = jnp.concatenate([row, jnp.full((pad,), M, index_dtype)])
        col = jnp.concatenate([col, jnp.full((pad,), N, index_dtype)])
        if value is not None:
            value = jnp.asarray(value)
            value = jnp.concatenate(
                [value, jnp.zeros((pad,) + value.shape[1:], value.dtype)])
        return cls(row=row, col=col, value=value,
                   nnz=jnp.asarray(n, jnp.int32), shape=(M, N))

    @classmethod
    def from_eager(cls, tensor, capacity: Optional[int] = None,
                   index_dtype=jnp.int32) -> "PaddedCOO":
        """From a facade ``SparseTensor`` (row-sorted by construction)."""
        r, c, v = tensor.coo()
        return cls.from_arrays(r, c, v, tensor.sparse_sizes(),
                               capacity=capacity, index_dtype=index_dtype)

    def to_eager(self):
        """Back to the eager facade, dropping padding (host sync)."""
        from ..tensor import SparseTensor
        n = int(self.nnz)
        value = None if self.value is None else self.value[:n]
        return SparseTensor(row=self.row[:n], col=self.col[:n], value=value,
                            sparse_sizes=self.shape, is_sorted=True,
                            trust_data=True)

    # ------------------------------------------------------------------
    # jittable compute
    # ------------------------------------------------------------------
    def spmm(self, x: jax.Array, reduce: str = "sum",
             backend: str = "auto") -> jax.Array:
        """``self @ x`` (dense x, any trailing dims).  Padding accumulates
        into dead row slot M which is sliced off."""
        out = spmm_coo(self.row, self.col, self.value, x, self.M + 1, reduce,
                       backend=backend)
        return out[:self.M]

    def transpose(self) -> "PaddedCOO":
        """Swap axes; re-sort so the result is canonical.  Padding entries
        (M, N) become (N, M) and still sort last."""
        perm = jnp.lexsort((self.row, self.col))
        value = None if self.value is None else self.value[perm]
        return PaddedCOO(row=self.col[perm], col=self.row[perm], value=value,
                         nnz=self.nnz, shape=(self.N, self.M))

    def sort(self) -> "PaddedCOO":
        perm = jnp.lexsort((self.col, self.row))
        value = None if self.value is None else self.value[perm]
        return PaddedCOO(row=self.row[perm], col=self.col[perm], value=value,
                         nnz=self.nnz, shape=self.shape)

    def coalesce(self, assume_sorted: bool = True) -> "PaddedCOO":
        """Merge duplicate coordinates (sum), keeping capacity static."""
        mat = self if assume_sorted else self.sort()
        row, col, value = mat.row, mat.col, mat.value
        cap = mat.capacity
        valid = row < self.M

        first = jnp.concatenate([
            valid[:1],
            valid[1:] & ((row[1:] != row[:-1]) | (col[1:] != col[:-1])),
        ])
        seg = jnp.cumsum(first) - 1                     # output slot per entry
        seg = jnp.where(valid, seg, cap - 1)            # pads -> last slot
        new_nnz = jnp.sum(first).astype(jnp.int32)

        idx_dtype = row.dtype
        out_row = jnp.full((cap,), self.M, idx_dtype)
        out_col = jnp.full((cap,), self.N, idx_dtype)
        keep_slots = jnp.where(first, seg, cap)         # drop non-first
        out_row = out_row.at[keep_slots].set(row, mode="drop")
        out_col = out_col.at[keep_slots].set(col, mode="drop")
        # slot cap-1 may have been clobbered by a dropped pad write path; fix:
        out_row = jnp.where(jnp.arange(cap) < new_nnz, out_row, self.M)
        out_col = jnp.where(jnp.arange(cap) < new_nnz, out_col, self.N)

        out_value = None
        if value is not None:
            contrib = jnp.where(
                valid.reshape((-1,) + (1,) * (value.ndim - 1)), value, 0)
            out_value = jax.ops.segment_sum(contrib, seg, num_segments=cap,
                                            indices_are_sorted=True)
            out_value = jnp.where(
                (jnp.arange(cap) < new_nnz).reshape(
                    (-1,) + (1,) * (value.ndim - 1)),
                out_value, 0)
        return PaddedCOO(row=out_row, col=out_col, value=out_value,
                         nnz=new_nnz, shape=self.shape)

    def with_value(self, value: Optional[jax.Array]) -> "PaddedCOO":
        if value is not None:
            mask = self.valid_mask()
            value = jnp.where(
                mask.reshape((-1,) + (1,) * (value.ndim - 1)), value, 0)
        return dataclasses.replace(self, value=value)

    def degree(self) -> jax.Array:
        """Out-degree per row (padding excluded)."""
        ones = jnp.where(self.valid_mask(), 1, 0)
        return jax.ops.segment_sum(ones, self.row, num_segments=self.M + 1,
                                   indices_are_sorted=True)[:self.M]
