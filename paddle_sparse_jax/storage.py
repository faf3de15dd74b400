"""Eager sparse storage: canonical row-sorted COO with lazily-derived
CSR/CSC views.

This is the JAX re-design of the reference storage core
(``/root/reference/paddle_sparse/storage.py``).  The two load-bearing ideas
survive (SURVEY.md §7): one canonical row-major-sorted COO layout, and a lazy
cache of derived fields (rowptr / rowcount / colptr / colcount / csr2csc /
csc2csr) that structural ops preserve when they can.  Everything else is
different:

* No native extension: ``ind2ptr``/``ptr2ind`` are vectorized XLA
  ``searchsorted`` calls (:mod:`paddle_sparse_jax.ops.convert`) instead of the
  reference's C++/CUDA custom ops (``csrc/convert.cpp``).
* No flat ``row * N + col`` sort keys anywhere — canonicalization is a
  (row, col) lexicographic stable sort, immune to index overflow.
* Arrays are immutable ``jax.Array``s.  "Mutation" methods (``set_value_``,
  ``fill_cache_``) rebind fields on the Python object; the arrays themselves
  are never written in place.  This object is the *eager host facade* —
  jit-compiled compute uses the static-shape pytree in
  :mod:`paddle_sparse_jax.core` instead.

Autograd note: the reference toggles ``value.stop_gradient``; JAX autograd is
functional, so "autograd on value" here means every op is differentiable
w.r.t. ``value`` when used through the functional API (``ops/``).
"""
import warnings
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .ops.convert import ind2ptr, ptr2ind
from .ops.segment import scatter_reduce, segment_csr
from .utils import as_index_array, is_row_col_sorted, lexsort_rowcol

LAYOUTS = ("coo", "csr", "csc")

_CACHE_KEYS = ("rowcount", "colptr", "colcount", "csr2csc", "csc2csr")


def get_layout(layout: Optional[str] = None) -> str:
    if layout is None:
        layout = "coo"
        warnings.warn(
            "`layout` argument unset, using default layout `coo` | "
            "specify `coo`, `csr` or `csc` explicitly", stacklevel=3)
    assert layout in LAYOUTS
    return layout


def _device_of(arr: jax.Array):
    devs = arr.devices() if hasattr(arr, "devices") else None
    if devs:
        return next(iter(devs))
    return jax.devices()[0]


class SparseStorage:
    """Canonical sparse storage (2-D, row-major-sorted COO + cached views)."""

    __slots__ = ("_row", "_rowptr", "_col", "_value", "_sparse_sizes",
                 "_rowcount", "_colptr", "_colcount", "_csr2csc", "_csc2csr")

    def __init__(self,
                 row: Optional[jax.Array] = None,
                 rowptr: Optional[jax.Array] = None,
                 col: Optional[jax.Array] = None,
                 value: Optional[jax.Array] = None,
                 sparse_sizes: Optional[Tuple[Optional[int], Optional[int]]] = None,
                 rowcount: Optional[jax.Array] = None,
                 colptr: Optional[jax.Array] = None,
                 colcount: Optional[jax.Array] = None,
                 csr2csc: Optional[jax.Array] = None,
                 csc2csr: Optional[jax.Array] = None,
                 is_sorted: bool = False,
                 trust_data: bool = False):
        assert row is not None or rowptr is not None, \
            "either `row` or `rowptr` must be given"
        assert col is not None, "`col` is required"

        col = as_index_array(col)
        if row is not None:
            row = as_index_array(row, dtype=col.dtype)
        if rowptr is not None:
            rowptr = as_index_array(rowptr, dtype=col.dtype)

        # --- infer / validate sparse sizes ------------------------------
        M: Optional[int] = None
        N: Optional[int] = None
        if sparse_sizes is not None:
            M, N = sparse_sizes
        if M is None:
            if rowptr is not None:
                M = int(rowptr.shape[0]) - 1
            else:
                M = int(row.max()) + 1 if row.shape[0] > 0 else 0
        if N is None:
            N = int(col.max()) + 1 if col.shape[0] > 0 else 0
        M, N = int(M), int(N)

        if not trust_data:
            assert col.ndim == 1
            if row is not None:
                assert row.ndim == 1 and row.shape[0] == col.shape[0]
                if row.shape[0] > 0:
                    assert int(row.min()) >= 0 and int(row.max()) < M, \
                        "row index out of bounds"
            if rowptr is not None:
                assert rowptr.ndim == 1 and rowptr.shape[0] == M + 1
            if col.shape[0] > 0:
                assert int(col.min()) >= 0 and int(col.max()) < N, \
                    "col index out of bounds"
            if value is not None:
                value = jnp.asarray(value)
                assert value.shape[0] == col.shape[0], \
                    "`value` length must equal nnz"
            for aux, length in ((rowcount, M), (colcount, N),
                                (colptr, N + 1)):
                if aux is not None:
                    assert jnp.asarray(aux).shape[0] == length
        elif value is not None:
            value = jnp.asarray(value)

        # --- canonicalize (sort by (row, col)) --------------------------
        if not is_sorted and col.shape[0] > 1:
            if row is None:
                row = ptr2ind(rowptr, int(col.shape[0]))
            if not is_row_col_sorted(row, col):
                perm = lexsort_rowcol(row, col)
                row = row[perm]
                col = col[perm]
                if value is not None:
                    value = value[perm]
                # count/pointer caches depend only on the (row, col)
                # multiset and stay valid; permutation caches do not.
                csr2csc = csc2csr = None

        self._row = row
        self._rowptr = rowptr
        self._col = col
        self._value = value
        self._sparse_sizes = (M, N)
        self._rowcount = rowcount
        self._colptr = colptr
        self._colcount = colcount
        self._csr2csc = csr2csc
        self._csc2csr = csc2csr

    # ------------------------------------------------------------------
    # empty / factory
    # ------------------------------------------------------------------
    @classmethod
    def empty(cls) -> "SparseStorage":
        idx = jnp.zeros((0,), dtype=jnp.int32)
        return cls(row=idx, col=idx, sparse_sizes=(0, 0), is_sorted=True,
                   trust_data=True)

    # ------------------------------------------------------------------
    # primary fields
    # ------------------------------------------------------------------
    def has_row(self) -> bool:
        return self._row is not None

    def row(self) -> jax.Array:
        if self._row is None:
            self._row = ptr2ind(self._rowptr, int(self._col.shape[0]))
        return self._row

    def has_rowptr(self) -> bool:
        return self._rowptr is not None

    def rowptr(self) -> jax.Array:
        if self._rowptr is None:
            self._rowptr = ind2ptr(self.row(), self._sparse_sizes[0])
        return self._rowptr

    def col(self) -> jax.Array:
        return self._col

    def has_value(self) -> bool:
        return self._value is not None

    def value(self) -> Optional[jax.Array]:
        return self._value

    def set_value_(self, value: Optional[jax.Array],
                   layout: Optional[str] = None) -> "SparseStorage":
        if value is not None:
            value = jnp.asarray(value)
            if get_layout(layout) == "csc":
                value = value[self.csc2csr()]
            assert value.shape[0] == self._col.shape[0]
        self._value = value
        return self

    def set_value(self, value: Optional[jax.Array],
                  layout: Optional[str] = None) -> "SparseStorage":
        if value is not None:
            value = jnp.asarray(value)
            if get_layout(layout) == "csc":
                value = value[self.csc2csr()]
            assert value.shape[0] == self._col.shape[0]
        return self._replace(value=value)

    # ------------------------------------------------------------------
    # sizes
    # ------------------------------------------------------------------
    def sparse_sizes(self) -> Tuple[int, int]:
        return self._sparse_sizes

    def sparse_size(self, dim: int) -> int:
        return self._sparse_sizes[dim]

    def nnz(self) -> int:
        return int(self._col.shape[0])

    def sparse_resize(self, sparse_sizes: Tuple[int, int]) -> "SparseStorage":
        assert len(sparse_sizes) == 2
        old_M, old_N = self._sparse_sizes
        M, N = int(sparse_sizes[0]), int(sparse_sizes[1])
        nnz = self.nnz()

        def _resize_ptr(ptr, diff):
            if ptr is None or diff == 0:
                return ptr
            if diff > 0:
                pad = jnp.full((diff,), nnz, dtype=ptr.dtype)
                return jnp.concatenate([ptr, pad])
            return ptr[:diff]

        def _resize_count(cnt, diff):
            if cnt is None or diff == 0:
                return cnt
            if diff > 0:
                return jnp.concatenate([cnt, jnp.zeros((diff,), cnt.dtype)])
            return cnt[:diff]

        return SparseStorage(
            row=self._row, rowptr=_resize_ptr(self._rowptr, M - old_M),
            col=self._col, value=self._value, sparse_sizes=(M, N),
            rowcount=_resize_count(self._rowcount, M - old_M),
            colptr=_resize_ptr(self._colptr, N - old_N),
            colcount=_resize_count(self._colcount, N - old_N),
            csr2csc=self._csr2csc, csc2csr=self._csc2csr,
            is_sorted=True, trust_data=True)

    def sparse_reshape(self, num_rows: int, num_cols: int) -> "SparseStorage":
        assert num_rows > 0 or num_rows == -1
        assert num_cols > 0 or num_cols == -1
        total = self.sparse_size(0) * self.sparse_size(1)
        if num_rows == -1:
            num_rows = total // num_cols
        if num_cols == -1:
            num_cols = total // num_rows
        assert num_rows * num_cols == total

        # flat-key arithmetic in 64-bit on host: immune to int32 overflow
        # regardless of the jax x64 mode.
        flat = (np.asarray(self.row(), dtype=np.int64) * self.sparse_size(1)
                + np.asarray(self._col, dtype=np.int64))
        row = jnp.asarray(flat // num_cols, dtype=self._col.dtype)
        col = jnp.asarray(flat % num_cols, dtype=self._col.dtype)
        return SparseStorage(row=row, col=col, value=self._value,
                             sparse_sizes=(int(num_rows), int(num_cols)),
                             is_sorted=True, trust_data=True)

    # ------------------------------------------------------------------
    # derived (cached) fields
    # ------------------------------------------------------------------
    def has_rowcount(self) -> bool:
        return self._rowcount is not None

    def rowcount(self) -> jax.Array:
        if self._rowcount is None:
            ptr = self.rowptr()
            self._rowcount = ptr[1:] - ptr[:-1]
        return self._rowcount

    def has_colptr(self) -> bool:
        return self._colptr is not None

    def colptr(self) -> jax.Array:
        if self._colptr is None:
            self._colptr = ind2ptr(self._col[self.csr2csc()],
                                   self._sparse_sizes[1])
        return self._colptr

    def has_colcount(self) -> bool:
        return self._colcount is not None

    def colcount(self) -> jax.Array:
        if self._colcount is None:
            ones = jnp.ones_like(self._col)
            self._colcount = scatter_reduce(ones, self._col,
                                            self._sparse_sizes[1], "sum")
        return self._colcount

    def has_csr2csc(self) -> bool:
        return self._csr2csc is not None

    def csr2csc(self) -> jax.Array:
        if self._csr2csc is None:
            # column-major order of the row-sorted entries; stable lexsort
            # keeps row order within a column — no flat N*col + row key.
            self._csr2csc = jnp.lexsort((self.row(), self._col)).astype(
                self._col.dtype)
        return self._csr2csc

    def has_csc2csr(self) -> bool:
        return self._csc2csr is not None

    def csc2csr(self) -> jax.Array:
        if self._csc2csr is None:
            self._csc2csr = jnp.argsort(self.csr2csc()).astype(self._col.dtype)
        return self._csc2csr

    # ------------------------------------------------------------------
    # coalescing
    # ------------------------------------------------------------------
    def is_coalesced(self) -> bool:
        row, col = self.row(), self._col
        if row.shape[0] < 2:
            return True
        strictly = (row[1:] > row[:-1]) | ((row[1:] == row[:-1]) &
                                           (col[1:] > col[:-1]))
        return bool(strictly.all())

    def coalesce(self, reduce: str = "add") -> "SparseStorage":
        row, col = self.row(), self._col
        nnz = self.nnz()
        if nnz == 0:
            return self
        keep = jnp.concatenate([
            jnp.ones((1,), dtype=bool),
            (row[1:] > row[:-1]) | ((row[1:] == row[:-1]) & (col[1:] > col[:-1])),
        ])
        if bool(keep.all()):
            return self

        new_row = row[keep]
        new_col = col[keep]
        value = self._value
        if value is not None:
            starts = jnp.nonzero(keep)[0].astype(self._col.dtype)
            ptr = jnp.concatenate(
                [starts, jnp.asarray([nnz], dtype=starts.dtype)])
            value = segment_csr(value, ptr, reduce=reduce)

        return SparseStorage(row=new_row, col=new_col, value=value,
                             sparse_sizes=self._sparse_sizes,
                             is_sorted=True, trust_data=True)

    # ------------------------------------------------------------------
    # cache management
    # ------------------------------------------------------------------
    def fill_cache_(self) -> "SparseStorage":
        self.row()
        self.rowptr()
        self.rowcount()
        self.colptr()
        self.colcount()
        self.csr2csc()
        self.csc2csr()
        return self

    def clear_cache_(self) -> "SparseStorage":
        self._rowcount = None
        self._colptr = None
        self._colcount = None
        self._csr2csc = None
        self._csc2csr = None
        return self

    def cached_keys(self) -> List[str]:
        return [k for k in _CACHE_KEYS
                if getattr(self, f"_{k}") is not None]

    def num_cached_keys(self) -> int:
        return len(self.cached_keys())

    # ------------------------------------------------------------------
    # copies & moves
    # ------------------------------------------------------------------
    def _replace(self, **updates) -> "SparseStorage":
        fields = dict(row=self._row, rowptr=self._rowptr, col=self._col,
                      value=self._value, sparse_sizes=self._sparse_sizes,
                      rowcount=self._rowcount, colptr=self._colptr,
                      colcount=self._colcount, csr2csc=self._csr2csc,
                      csc2csr=self._csc2csr)
        fields.update(updates)
        return SparseStorage(is_sorted=True, trust_data=True, **fields)

    def copy(self) -> "SparseStorage":
        """New storage object sharing the same (immutable) array buffers."""
        return self._replace()

    def clone(self) -> "SparseStorage":
        """New storage object with freshly-copied array buffers."""
        def cp(a):
            return None if a is None else jnp.array(a, copy=True)
        return SparseStorage(
            row=cp(self._row), rowptr=cp(self._rowptr), col=cp(self._col),
            value=cp(self._value), sparse_sizes=self._sparse_sizes,
            rowcount=cp(self._rowcount), colptr=cp(self._colptr),
            colcount=cp(self._colcount), csr2csc=cp(self._csr2csc),
            csc2csr=cp(self._csc2csr), is_sorted=True, trust_data=True)

    def apply_value(self, fn) -> "SparseStorage":
        value = self._value
        return self._replace(value=None if value is None else fn(value))

    def apply_value_(self, fn) -> "SparseStorage":
        if self._value is not None:
            self._value = fn(self._value)
        return self

    def apply(self, fn) -> "SparseStorage":
        """Apply ``fn`` to every array field (e.g. a device move)."""
        def mp(a):
            return None if a is None else fn(a)
        return SparseStorage(
            row=mp(self._row), rowptr=mp(self._rowptr), col=mp(self._col),
            value=mp(self._value), sparse_sizes=self._sparse_sizes,
            rowcount=mp(self._rowcount), colptr=mp(self._colptr),
            colcount=mp(self._colcount), csr2csc=mp(self._csr2csc),
            csc2csr=mp(self._csc2csr), is_sorted=True, trust_data=True)

    def apply_(self, fn) -> "SparseStorage":
        for name in ("_row", "_rowptr", "_col", "_value", "_rowcount",
                     "_colptr", "_colcount", "_csr2csc", "_csc2csr"):
            arr = getattr(self, name)
            if arr is not None:
                setattr(self, name, fn(arr))
        return self

    def map_indices(self, fn) -> "SparseStorage":
        """Apply ``fn`` to index-typed fields only (dtype casts)."""
        def mp(a):
            return None if a is None else fn(a)
        return SparseStorage(
            row=mp(self._row), rowptr=mp(self._rowptr), col=mp(self._col),
            value=self._value, sparse_sizes=self._sparse_sizes,
            rowcount=mp(self._rowcount), colptr=mp(self._colptr),
            colcount=mp(self._colcount), csr2csc=mp(self._csr2csc),
            csc2csr=mp(self._csc2csr), is_sorted=True, trust_data=True)

    def device(self):
        return _device_of(self._col)

    def to_device(self, device) -> "SparseStorage":
        if isinstance(device, str):
            device = jax.devices(device)[0]
        return self.apply(lambda a: jax.device_put(a, device))

    def cpu(self) -> "SparseStorage":
        return self.to_device("cpu")

    def cuda(self) -> "SparseStorage":
        """Move to the first GPU (raises when there is none)."""
        try:
            gpus = jax.devices("gpu")
        except RuntimeError:
            gpus = []
        if not gpus:
            raise RuntimeError("no GPU device available")
        return self.to_device(gpus[0])

    def is_cuda(self) -> bool:
        return self.device().platform == "gpu"

    def pin_memory(self) -> "SparseStorage":  # pragma: no cover
        warnings.warn("pin_memory is a no-op in JAX")
        return self

    def is_pinned(self) -> bool:  # pragma: no cover
        return False

    def share_memory_(self) -> "SparseStorage":
        """JAX arrays are immutable and freely shareable; no-op."""
        return self

    def is_shared(self) -> bool:
        return True
