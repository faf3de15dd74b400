"""User-facing 2-D sparse matrix facade.

JAX re-design of the reference SparseTensor
(``/root/reference/paddle_sparse/tensor.py``): same user API (constructors,
COO/CSR/CSC views, stats, conversions, ``__getitem__`` dispatch), but backed
by immutable ``jax.Array`` storage and with all flat-key index arithmetic
replaced by overflow-safe lexicographic sorts.

Op families (narrow/select/add/mul/reduce/cat/matmul/diag/...) attach their
methods at import time from ``paddle_sparse_jax/__init__.py``, mirroring the
reference's module layout so that users can find each op where they expect it.

Autograd: JAX is functionally differentiated, so ``requires_grad_`` and
``detach`` are compatibility shims; real gradients flow through the
functional ops (``paddle_sparse_jax.ops``) which carry ``custom_vjp`` rules
differentiating w.r.t. ``value`` only (reference semantics, ``README.md:96``).
"""
from textwrap import indent
from typing import Any, List, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse

from .ops.segment import segment_csr
from .storage import SparseStorage, get_layout
from .utils import lexsort_rowcol


class SparseTensor:
    storage: SparseStorage

    def __init__(self,
                 row: Optional[jax.Array] = None,
                 rowptr: Optional[jax.Array] = None,
                 col: Optional[jax.Array] = None,
                 value: Optional[jax.Array] = None,
                 sparse_sizes: Optional[Tuple[Optional[int], Optional[int]]] = None,
                 is_sorted: bool = False,
                 trust_data: bool = False):
        self.storage = SparseStorage(row=row, rowptr=rowptr, col=col,
                                     value=value, sparse_sizes=sparse_sizes,
                                     is_sorted=is_sorted,
                                     trust_data=trust_data)

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------
    @classmethod
    def from_storage(cls, storage: SparseStorage) -> "SparseTensor":
        out = cls.__new__(cls)
        out.storage = storage.copy()
        return out

    @classmethod
    def from_edge_index(cls, edge_index, edge_attr=None, sparse_sizes=None,
                        is_sorted: bool = False,
                        trust_data: bool = False) -> "SparseTensor":
        edge_index = jnp.asarray(edge_index)
        return cls(row=edge_index[0], col=edge_index[1], value=edge_attr,
                   sparse_sizes=sparse_sizes, is_sorted=is_sorted,
                   trust_data=trust_data)

    @classmethod
    def from_dense(cls, mat, has_value: bool = True) -> "SparseTensor":
        mat = jnp.asarray(mat)
        if mat.ndim > 2:
            nz = jnp.abs(mat).sum(axis=tuple(range(2, mat.ndim)))
        else:
            nz = mat
        row, col = jnp.nonzero(nz)
        value = mat[row, col] if has_value else None
        return cls(row=row, col=col, value=value,
                   sparse_sizes=(mat.shape[0], mat.shape[1]),
                   is_sorted=True, trust_data=True)

    @classmethod
    def eye(cls, M: int, N: Optional[int] = None, has_value: bool = True,
            dtype=None, device=None, fill_cache: bool = False) -> "SparseTensor":
        N = M if N is None else N
        k = min(M, N)
        idx_dtype = jnp.asarray(0).dtype  # default int dtype (int64 under x64)
        row = jnp.arange(k, dtype=idx_dtype)
        col = row
        rowptr = jnp.minimum(jnp.arange(M + 1, dtype=idx_dtype), k)
        value = jnp.ones((k,), dtype=dtype) if has_value else None

        out = cls(row=row, rowptr=rowptr, col=col, value=value,
                  sparse_sizes=(M, N), is_sorted=True, trust_data=True)
        if fill_cache:
            s = out.storage
            s._rowcount = (jnp.arange(M, dtype=idx_dtype) < k).astype(idx_dtype)
            s._colptr = jnp.minimum(jnp.arange(N + 1, dtype=idx_dtype), k)
            s._colcount = (jnp.arange(N, dtype=idx_dtype) < k).astype(idx_dtype)
            s._csr2csc = row
            s._csc2csr = row
        if device is not None:
            out = out.to_device(device)
        return out

    # ------------------------------------------------------------------
    # copies / dtype / device
    # ------------------------------------------------------------------
    def copy(self) -> "SparseTensor":
        return self.from_storage(self.storage)

    def clone(self) -> "SparseTensor":
        return self.from_storage(self.storage.clone())

    def type(self, dtype, non_blocking: bool = False) -> "SparseTensor":
        value = self.storage.value()
        if value is None or dtype == value.dtype:
            return self
        return self.from_storage(
            self.storage.apply_value(lambda v: v.astype(dtype)))

    astype = type

    def type_as(self, tensor, non_blocking: bool = False) -> "SparseTensor":
        return self.type(jnp.asarray(tensor).dtype)

    def index_dtype(self):
        return self.storage.col().dtype

    def with_index_dtype(self, dtype) -> "SparseTensor":
        """Cast all index arrays (int32 <-> int64)."""
        return self.from_storage(
            self.storage.map_indices(lambda a: a.astype(dtype)))

    def to_device(self, device, non_blocking: bool = False) -> "SparseTensor":
        return self.from_storage(self.storage.to_device(device))

    def device_as(self, tensor, non_blocking: bool = False) -> "SparseTensor":
        dev = next(iter(tensor.devices())) if hasattr(tensor, "devices") \
            else jax.devices()[0]
        return self.to_device(dev)

    def device(self):
        return self.storage.device()

    def cpu(self) -> "SparseTensor":
        return self.to_device("cpu")

    def cuda(self, device=None, non_blocking: bool = False) -> "SparseTensor":
        return self.from_storage(self.storage.cuda())

    def is_cuda(self) -> bool:
        return self.storage.is_cuda()

    def pin_memory(self) -> "SparseTensor":
        return self.from_storage(self.storage.pin_memory())

    def is_pinned(self) -> bool:
        return self.storage.is_pinned()

    def share_memory_(self) -> "SparseTensor":
        self.storage.share_memory_()
        return self

    def is_shared(self) -> bool:
        return self.storage.is_shared()

    # ------------------------------------------------------------------
    # formats
    # ------------------------------------------------------------------
    def coo(self):
        return self.storage.row(), self.storage.col(), self.storage.value()

    def csr(self):
        return self.storage.rowptr(), self.storage.col(), self.storage.value()

    def csc(self):
        perm = self.storage.csr2csc()
        value = self.storage.value()
        if value is not None:
            value = value[perm]
        return self.storage.colptr(), self.storage.row()[perm], value

    # ------------------------------------------------------------------
    # storage inheritance
    # ------------------------------------------------------------------
    def has_value(self) -> bool:
        return self.storage.has_value()

    def set_value_(self, value, layout: Optional[str] = None) -> "SparseTensor":
        self.storage.set_value_(value, layout)
        return self

    def set_value(self, value, layout: Optional[str] = None) -> "SparseTensor":
        return self.from_storage(self.storage.set_value(value, layout))

    def sparse_sizes(self) -> Tuple[int, int]:
        return self.storage.sparse_sizes()

    def sparse_size(self, dim: int) -> int:
        return self.storage.sparse_sizes()[dim]

    def sparse_resize(self, sparse_sizes) -> "SparseTensor":
        return self.from_storage(self.storage.sparse_resize(sparse_sizes))

    def sparse_reshape(self, num_rows: int, num_cols: int) -> "SparseTensor":
        return self.from_storage(
            self.storage.sparse_reshape(num_rows, num_cols))

    def is_coalesced(self) -> bool:
        return self.storage.is_coalesced()

    def coalesce(self, reduce: str = "sum") -> "SparseTensor":
        return self.from_storage(self.storage.coalesce(reduce))

    def fill_cache_(self) -> "SparseTensor":
        self.storage.fill_cache_()
        return self

    def clear_cache_(self) -> "SparseTensor":
        self.storage.clear_cache_()
        return self

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, self.__class__):
            return False
        if self.sizes() != other.sizes():
            return False
        rowptrA, colA, valueA = self.csr()
        rowptrB, colB, valueB = other.csr()
        if (valueA is None) != (valueB is None):
            return False
        if not bool(jnp.array_equal(rowptrA, rowptrB)):
            return False
        if not bool(jnp.array_equal(colA, colB)):
            return False
        if valueA is None:
            return True
        return bool(jnp.array_equal(valueA, valueB))

    __hash__ = object.__hash__

    # ------------------------------------------------------------------
    # utility
    # ------------------------------------------------------------------
    def fill_value_(self, fill_value: float, dtype=None) -> "SparseTensor":
        value = jnp.full((self.nnz(),), fill_value, dtype=dtype)
        return self.set_value_(value, layout="coo")

    def fill_value(self, fill_value: float, dtype=None) -> "SparseTensor":
        value = jnp.full((self.nnz(),), fill_value, dtype=dtype)
        return self.set_value(value, layout="coo")

    def sizes(self) -> List[int]:
        sparse_sizes = list(self.sparse_sizes())
        value = self.storage.value()
        if value is not None:
            return sparse_sizes + list(value.shape)[1:]
        return sparse_sizes

    def size(self, dim: int) -> int:
        return self.sizes()[dim]

    def dim(self) -> int:
        return len(self.sizes())

    def nnz(self) -> int:
        return self.storage.nnz()

    def numel(self) -> int:
        value = self.storage.value()
        return int(np.prod(value.shape)) if value is not None else self.nnz()

    def density(self) -> float:
        M, N = self.sparse_sizes()
        if M == 0 or N == 0:
            return 0.0
        return self.nnz() / (M * N)

    def sparsity(self) -> float:
        return 1.0 - self.density()

    def avg_row_length(self) -> float:
        return self.nnz() / self.sparse_size(0)

    def avg_col_length(self) -> float:
        return self.nnz() / self.sparse_size(1)

    def bandwidth(self) -> int:
        row, col, _ = self.coo()
        return int(jnp.abs(row - col).max())

    def avg_bandwidth(self) -> float:
        row, col, _ = self.coo()
        return float(jnp.abs(row - col).astype(jnp.float32).mean())

    def bandwidth_proportion(self, bandwidth: int) -> float:
        row, col, _ = self.coo()
        return int((jnp.abs(row - col) <= bandwidth).sum()) / self.nnz()

    def is_quadratic(self) -> bool:
        return self.sparse_size(0) == self.sparse_size(1)

    def is_symmetric(self) -> bool:
        if not self.is_quadratic():
            return False
        rowptrA, colA, valueA = self.csr()
        colptrB, rowB, valueB = self.csc()
        if not bool(jnp.array_equal(rowptrA, colptrB)):
            return False
        if not bool(jnp.array_equal(colA, rowB)):
            return False
        if valueA is None or valueB is None:
            return True
        return bool((valueA == valueB).all())

    def to_symmetric(self, reduce: str = "sum") -> "SparseTensor":
        """Return ``A + A^T`` structurally (values merged by ``reduce``)."""
        N = max(self.size(0), self.size(1))
        row, col, value = self.coo()

        all_row = jnp.concatenate([row, col])
        all_col = jnp.concatenate([col, row])
        perm = lexsort_rowcol(all_row, all_col)
        srow, scol = all_row[perm], all_col[perm]

        keep = jnp.concatenate([
            jnp.ones((1,), bool),
            (srow[1:] > srow[:-1]) | ((srow[1:] == srow[:-1]) &
                                      (scol[1:] > scol[:-1])),
        ])
        new_row, new_col = srow[keep], scol[keep]

        if value is not None:
            starts = jnp.nonzero(keep)[0].astype(col.dtype)
            ptr = jnp.concatenate(
                [starts, jnp.asarray([srow.shape[0]], dtype=starts.dtype)])
            value = segment_csr(jnp.concatenate([value, value])[perm], ptr,
                                reduce=reduce)

        return SparseTensor(row=new_row, col=new_col, value=value,
                            sparse_sizes=(N, N), is_sorted=True,
                            trust_data=True)

    # ------------------------------------------------------------------
    # autograd compatibility shims (JAX differentiates functionally)
    # ------------------------------------------------------------------
    def detach_(self) -> "SparseTensor":
        value = self.storage.value()
        if value is not None:
            self.storage.set_value_(jax.lax.stop_gradient(value), layout="coo")
        return self

    def detach(self) -> "SparseTensor":
        value = self.storage.value()
        if value is not None:
            value = jax.lax.stop_gradient(value)
        return self.set_value(value, layout="coo")

    def requires_grad(self) -> bool:
        return self.has_value()

    def requires_grad_(self, requires_grad: bool = True,
                       dtype=None) -> "SparseTensor":
        if requires_grad and not self.has_value():
            self.fill_value_(1.0, dtype)
        return self

    # ------------------------------------------------------------------
    # dtype helpers
    # ------------------------------------------------------------------
    def dtype(self):
        value = self.storage.value()
        return value.dtype if value is not None else jnp.float32

    def is_floating_point(self) -> bool:
        value = self.storage.value()
        return value is None or jnp.issubdtype(value.dtype, jnp.floating)

    def bfloat16(self):
        return self.type(jnp.bfloat16)

    def bool(self):
        return self.type(jnp.bool_)

    def byte(self):
        return self.type(jnp.uint8)

    def char(self):
        return self.type(jnp.int8)

    def half(self):
        return self.type(jnp.float16)

    def float(self):
        return self.type(jnp.float32)

    def double(self):
        return self.type(jnp.float64)

    def short(self):
        return self.type(jnp.int16)

    def int(self):
        return self.type(jnp.int32)

    def long(self):
        return self.type(jnp.int64)

    # ------------------------------------------------------------------
    # conversions
    # ------------------------------------------------------------------
    def to_dense(self, dtype=None) -> jax.Array:
        row, col, value = self.coo()
        if value is None:
            value = jnp.ones((self.nnz(),), dtype=dtype or jnp.float32)
        mat = jnp.zeros(tuple(self.sizes()), dtype=value.dtype)
        # duplicate (row, col) entries accumulate, matching sparse semantics
        return mat.at[row, col].add(value)

    def to_jax_bcoo(self):
        """Export as a ``jax.experimental.sparse.BCOO`` matrix."""
        from jax.experimental import sparse as jsparse
        row, col, value = self.coo()
        if value is None:
            value = jnp.ones((self.nnz(),), dtype=jnp.float32)
        indices = jnp.stack([row, col], axis=1)
        return jsparse.BCOO((value, indices), shape=tuple(self.sizes()),
                            indices_sorted=True, unique_indices=False)

    @classmethod
    def from_jax_bcoo(cls, mat) -> "SparseTensor":
        indices = mat.indices
        return cls(row=indices[:, 0], col=indices[:, 1], value=mat.data,
                   sparse_sizes=(mat.shape[0], mat.shape[1]))

    # Reference-compat names (reference tensor.py:110-155, :564-585): the
    # backing framework's native sparse type is jax.experimental.sparse
    # here, so the "paddle sparse tensor" bridges map onto BCOO/BCSR.
    def to_paddle_sparse_coo_tensor(self, dtype=None):
        out = self.to_jax_bcoo()
        return out if dtype is None else out.astype(dtype)

    @classmethod
    def from_paddle_sparse_coo_tensor(cls, mat,
                                      has_value: bool = True
                                      ) -> "SparseTensor":
        out = cls.from_jax_bcoo(mat)
        return out if has_value else out.set_value(None)

    def to_paddle_sparse_csr_tensor(self, dtype=None):
        """Export as ``jax.experimental.sparse.BCSR``."""
        from jax.experimental import sparse as jsparse
        rowptr, col, value = self.csr()
        if value is None:
            value = jnp.ones((self.nnz(),), dtype=dtype or jnp.float32)
        elif dtype is not None:
            value = value.astype(dtype)
        return jsparse.BCSR((value, col, rowptr), shape=tuple(self.sizes()))

    @classmethod
    def from_paddle_sparse_csr_tensor(cls, mat) -> "SparseTensor":
        return cls(rowptr=mat.indptr, col=mat.indices, value=mat.data,
                   sparse_sizes=(mat.shape[0], mat.shape[1]))

    def to_paddle_sparse_csc_tensor(self, dtype=None):
        # parity with the reference, which also raises (tensor.py:587-591)
        raise NotImplementedError(
            "jax.experimental.sparse has no CSC type; use csc() for the "
            "raw (colptr, row, value) triple")

    def to_padded(self, capacity: Optional[int] = None):
        """Export to the static-shape jit core type
        (:class:`paddle_sparse_jax.core.PaddedCOO`)."""
        from .core import PaddedCOO
        return PaddedCOO.from_eager(self, capacity=capacity)

    @classmethod
    def from_padded(cls, mat) -> "SparseTensor":
        return mat.to_eager()

    # ------------------------------------------------------------------
    # indexing & repr
    # ------------------------------------------------------------------
    def __getitem__(self, index: Any) -> "SparseTensor":
        index = list(index) if isinstance(index, tuple) else [index]
        n_ellipsis = sum(1 for i in index
                         if not isinstance(i, (jax.Array, np.ndarray))
                         and i is Ellipsis)
        if n_ellipsis > 1:
            raise SyntaxError("only one Ellipsis allowed")

        dim = 0
        out = self
        while len(index) > 0:
            item = index.pop(0)
            if isinstance(item, (list, tuple)):
                item = np.asarray(item)
            if isinstance(item, np.ndarray):
                item = jnp.asarray(item)

            if isinstance(item, (int, np.integer)):
                out = out.select(dim, int(item))
                dim += 1
            elif isinstance(item, slice):
                if item.step is not None:
                    raise ValueError("step slicing not supported")
                start = 0 if item.start is None else item.start
                start = self.size(dim) + start if start < 0 else start
                stop = self.size(dim) if item.stop is None else item.stop
                stop = self.size(dim) + stop if stop < 0 else stop
                out = out.narrow(dim, start, max(stop - start, 0))
                dim += 1
            elif isinstance(item, jax.Array):
                if item.dtype == jnp.bool_:
                    out = out.masked_select(dim, item)
                else:
                    out = out.index_select(dim, item)
                dim += 1
            elif item is Ellipsis:
                if self.dim() - len(index) < dim:
                    raise SyntaxError
                dim = self.dim() - len(index)
            else:
                raise SyntaxError(f"invalid index {item!r}")
        return out

    def __repr__(self) -> str:
        i = " " * 6
        row, col, value = self.coo()
        infos = [f"row={indent(repr(row), i)[len(i):]}",
                 f"col={indent(repr(col), i)[len(i):]}"]
        if value is not None:
            infos += [f"val={indent(repr(value), i)[len(i):]}"]
        infos += [f"size={tuple(self.sizes())}, nnz={self.nnz()}, "
                  f"density={100 * self.density():.02f}%"]
        body = ",\n".join(infos)
        pad = " " * (len(self.__class__.__name__) + 1)
        return f"{self.__class__.__name__}({indent(body, pad)[len(pad):]})"


# ---------------------------------------------------------------------------
# scipy bridge
# ---------------------------------------------------------------------------
ScipySparseMatrix = Union[scipy.sparse.coo_matrix, scipy.sparse.csr_matrix,
                          scipy.sparse.csc_matrix]


def from_scipy(mat: ScipySparseMatrix, has_value: bool = True) -> SparseTensor:
    colptr = None
    if isinstance(mat, scipy.sparse.csc_matrix):
        colptr = jnp.asarray(mat.indptr.astype(np.int64))
    csr = mat.tocsr()
    rowptr = jnp.asarray(csr.indptr.astype(np.int64))
    coo = csr.tocoo()
    row = jnp.asarray(coo.row.astype(np.int64))
    col = jnp.asarray(coo.col.astype(np.int64))
    value = jnp.asarray(coo.data) if has_value else None

    storage = SparseStorage(row=row, rowptr=rowptr, col=col, value=value,
                            sparse_sizes=coo.shape[:2], colptr=colptr,
                            is_sorted=True)
    return SparseTensor.from_storage(storage)


def to_scipy(self: SparseTensor, layout: Optional[str] = None,
             dtype=None) -> ScipySparseMatrix:
    assert self.dim() == 2
    layout = get_layout(layout)
    sizes = tuple(self.sizes())

    def val_np(value):
        if value is not None:
            return np.asarray(value)
        return np.ones((self.nnz(),), dtype=dtype or np.float32)

    if layout == "coo":
        row, col, value = self.coo()
        return scipy.sparse.coo_matrix(
            (val_np(value), (np.asarray(row), np.asarray(col))), sizes)
    if layout == "csr":
        rowptr, col, value = self.csr()
        return scipy.sparse.csr_matrix(
            (val_np(value), np.asarray(col), np.asarray(rowptr)), sizes)
    colptr, row, value = self.csc()
    return scipy.sparse.csc_matrix(
        (val_np(value), np.asarray(row), np.asarray(colptr)), sizes)


SparseTensor.from_scipy = from_scipy
SparseTensor.to_scipy = to_scipy


def to(self: SparseTensor, *args, **kwargs) -> SparseTensor:
    """torch/paddle-style combined dtype+device move
    (mirrors ``/root/reference/paddle_sparse/tensor.py:606-689``)."""
    device = None
    dtype = None
    if len(args) + len(kwargs) == 0:
        raise TypeError("to() expects at least one argument")

    for arg in args:
        if isinstance(arg, (jax.Array, np.ndarray)):
            dtype = arg.dtype
            if isinstance(arg, jax.Array) and arg.devices():
                device = next(iter(arg.devices()))
        elif isinstance(arg, bool):
            pass  # non_blocking flag - meaningless here
        elif isinstance(arg, jax.Device) or (
                isinstance(arg, str) and arg in ("cpu", "gpu")):
            device = arg
        else:
            try:
                dtype = jnp.dtype(arg)
            except TypeError:
                device = arg
    device = kwargs.get("device", device)
    dtype = kwargs.get("dtype", dtype)
    other = kwargs.get("other")
    if other is not None and device is None and dtype is None:
        dtype = other.dtype
        if hasattr(other, "devices"):
            device = next(iter(other.devices()))

    out = self
    if dtype is not None:
        out = out.type(dtype)
    if device is not None:
        out = out.to_device(device)
    return out


SparseTensor.to = to
