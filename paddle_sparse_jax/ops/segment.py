"""Segment / gather primitives over CSR pointers and COO segment ids.

Replacement for the reference's external ``paddle_scatter``
dependency (``scatter_add``, ``segment_csr``, ``gather_csr`` — see
``/root/reference/paddle_sparse/storage.py:10-11`` and ``reduce.py:6-7``).
Everything here lowers to XLA segment reductions / gathers — no native
extension required.

All reductions accumulate in the value dtype except ``mean`` which divides in
f32 for low-precision inputs.  ``segment_*`` functions take ``num_segments``
statically so they stay jittable.
"""
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from .convert import ptr2ind

REDUCTIONS = ("sum", "add", "mean", "min", "max")


def _seg_reduce(values, segment_ids, num_segments, reduce):
    kwargs = dict(num_segments=num_segments, indices_are_sorted=True)
    if reduce in ("sum", "add"):
        return jax.ops.segment_sum(values, segment_ids, **kwargs)
    if reduce == "min":
        return jax.ops.segment_min(values, segment_ids, **kwargs)
    if reduce == "max":
        return jax.ops.segment_max(values, segment_ids, **kwargs)
    if reduce == "mean":
        acc = values.astype(jnp.float32) if values.dtype in (jnp.float16, jnp.bfloat16) else values
        total = jax.ops.segment_sum(acc, segment_ids, **kwargs)
        ones = jnp.ones(values.shape[:1], dtype=total.dtype)
        count = jax.ops.segment_sum(ones, segment_ids, **kwargs)
        count = jnp.maximum(count, 1)
        out = total / count.reshape((-1,) + (1,) * (values.ndim - 1))
        return out.astype(values.dtype)
    raise ValueError(f"unknown reduction {reduce!r}")


def _fill_empty(out, counts, reduce):
    """Empty segments: sum/mean give 0; min/max give 0 (reference
    `segment_csr` semantics: out-of-range segments are zero-filled)."""
    if reduce in ("min", "max"):
        mask = (counts == 0).reshape((-1,) + (1,) * (out.ndim - 1))
        out = jnp.where(mask, jnp.zeros((), dtype=out.dtype), out)
    return out


def segment_csr(values: jax.Array, ptr: jax.Array, reduce: str = "sum") -> jax.Array:
    """Reduce ``values`` over segments delimited by CSR-style ``ptr``.

    ``out[i] = reduce(values[ptr[i]:ptr[i+1]])`` with zero for empty segments.
    """
    values = jnp.asarray(values)
    ptr = jnp.asarray(ptr)
    num_segments = ptr.shape[0] - 1
    seg_ids = ptr2ind(ptr, values.shape[0])
    out = _seg_reduce(values, seg_ids, num_segments, reduce)
    counts = ptr[1:] - ptr[:-1]
    return _fill_empty(out, counts, reduce)


def gather_csr(src: jax.Array, ptr: jax.Array, out_len: Optional[int] = None) -> jax.Array:
    """Inverse of :func:`segment_csr`: broadcast one entry per segment out to
    every element of that segment."""
    src = jnp.asarray(src)
    ptr = jnp.asarray(ptr)
    if out_len is None:
        out_len = int(ptr[-1])
    return src[ptr2ind(ptr, out_len)]


def gather_segments(ptr: jax.Array, idx: jax.Array):
    """Gather variable-length CSR segments ``[ptr[i], ptr[i+1])`` for every
    ``i`` in ``idx``, concatenated in ``idx`` order.

    The library's own primitive behind ``index_select`` on either sparse
    axis (gather rows of a CSR view / cols of a CSC view): returns
    ``(new_ptr, counts, seg_ids, perm)`` where ``perm`` indexes the source
    element arrays, ``seg_ids[k]`` is the output segment of element ``k``
    and ``new_ptr``/``counts`` describe the output segmentation.  Eager
    (the output length is data-dependent).
    """
    ptr = jnp.asarray(ptr)
    idx = jnp.asarray(idx)
    counts = ptr[idx + 1] - ptr[idx]
    new_ptr = jnp.concatenate([
        jnp.zeros((1,), ptr.dtype), jnp.cumsum(counts).astype(ptr.dtype)])
    total = int(new_ptr[-1])
    seg_ids = jnp.repeat(jnp.arange(idx.shape[0], dtype=ptr.dtype),
                         counts, total_repeat_length=total)
    # element k sits at offset (k - new_ptr[seg]) inside its segment;
    # add the source segment's start to get the source position
    perm = (jnp.arange(total, dtype=ptr.dtype)
            + (ptr[idx] - new_ptr[:-1])[seg_ids])
    return new_ptr, counts, seg_ids, perm


def scatter_reduce(values: jax.Array, index: jax.Array, num_segments: int,
                   reduce: str = "sum", indices_are_sorted: bool = False) -> jax.Array:
    """COO-style scatter-reduce (unsorted segment ids allowed)."""
    values = jnp.asarray(values)
    index = jnp.asarray(index)
    kwargs = dict(num_segments=num_segments, indices_are_sorted=indices_are_sorted)
    if reduce in ("sum", "add"):
        return jax.ops.segment_sum(values, index, **kwargs)
    if reduce == "min":
        out = jax.ops.segment_min(values, index, **kwargs)
    elif reduce == "max":
        out = jax.ops.segment_max(values, index, **kwargs)
    elif reduce == "mean":
        total = jax.ops.segment_sum(values, index, **kwargs)
        count = jax.ops.segment_sum(jnp.ones(values.shape[:1], total.dtype), index, **kwargs)
        return total / jnp.maximum(count, 1).reshape((-1,) + (1,) * (values.ndim - 1))
    else:
        raise ValueError(f"unknown reduction {reduce!r}")
    counts = jax.ops.segment_sum(jnp.ones(index.shape, jnp.int32), index, **kwargs)
    return _fill_empty(out, counts, reduce)


@partial(jax.jit, static_argnums=(2,))
def bincount(index: jax.Array, weights=None, length: int = 0) -> jax.Array:
    index = jnp.asarray(index)
    if weights is None:
        weights = jnp.ones(index.shape, dtype=index.dtype)
    return jax.ops.segment_sum(weights, index, num_segments=length)
