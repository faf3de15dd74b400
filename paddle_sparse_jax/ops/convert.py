"""Index-format conversions: COO row indices <-> CSR row pointers.

Replacement for the reference's native custom ops
(``/root/reference/csrc/convert.cpp:37-76``, ``csrc/cpu/convert_cpu.cpp:6-48``,
``csrc/cuda/convert_cuda.cu:6-68``).  The reference needs a C++/CUDA extension
because the conversions are sequential scans; here both directions are a
single vectorized ``searchsorted`` and therefore plain XLA:

* ``ind2ptr(row, M)``: for sorted ``row``, ``ptr[i] = #{k : row[k] < i}``,
  i.e. ``searchsorted(row, arange(M+1), side='left')``.
* ``ptr2ind(ptr, E)``: ``ind[e] = max{i : ptr[i] <= e}``,
  i.e. ``searchsorted(ptr, arange(E), side='right') - 1``.

Both are shape-polymorphic only in the *static* sense: ``M`` / ``E`` must be
Python ints, so the same functions work eagerly (exact nnz) and under ``jit``
(padded capacity).  Matches the reference contract including empty inputs
(``test/test_storage.py:16-32``).
"""
from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnums=(1,))
def ind2ptr(row: jax.Array, M: int) -> jax.Array:
    """Sorted COO row indices -> CSR row pointer of length ``M + 1``."""
    row = jnp.asarray(row)
    positions = jnp.arange(M + 1, dtype=row.dtype)
    return jnp.searchsorted(row, positions, side="left").astype(row.dtype)


@partial(jax.jit, static_argnums=(1,))
def _expand_ptr(ptr: jax.Array, E: int) -> jax.Array:
    """Scatter + cummax pointer expansion: ``out[t] = max i: ptr[i] <= t``.

    Replaces the searchsorted formulation — XLA lowers a binary search
    as ~log(rows) chained full-length gathers; the scatter-max + cummax
    pair is two linear passes.  Requires ``ptr[0] == 0``
    (canonical CSR pointers); duplicate starts (empty segments) resolve
    to the LAST segment via the scatter-max, matching searchsorted's
    ``side="right" - 1``."""
    n = ptr.shape[0] - 1
    if E == 0 or n <= 0:
        return jnp.zeros((E,), ptr.dtype)
    # drop (not clip!) starts at/past E: a segment starting at ptr[i] >= E
    # contributes nothing — clipping it to E-1 would corrupt the last
    # position when trailing segments are empty
    ids0 = jnp.zeros((E,), ptr.dtype).at[ptr[:-1]].max(
        jnp.arange(n, dtype=ptr.dtype), mode="drop")
    return jax.lax.cummax(ids0)


def ptr2ind(ptr: jax.Array, E: int) -> jax.Array:
    """CSR row pointer -> COO row indices of length ``E`` (= ptr[-1]).

    Requires CANONICAL pointers (``ptr[0] == 0``, the reference's
    contract too: ``csrc/cpu/convert_cpu.cpp:32-48`` iterates from
    ``ptr[0]``).  Non-rebased pointers are rebased defensively — the
    underlying scatter expansion would otherwise silently assign the
    positions before ``ptr[0]`` to segment 0 (ADVICE r4)."""
    ptr = jnp.asarray(ptr)
    return _expand_ptr(ptr - ptr[:1], E)


@partial(jax.jit, static_argnums=(1,))
def ptr2ind_capped(ptr: jax.Array, capacity: int) -> jax.Array:
    """Like :func:`ptr2ind` but for padded buffers: positions beyond
    ``ptr[-1]`` map to ``len(ptr) - 1`` (one-past-last row), the canonical
    padding row used by the static-shape core so padding sorts last."""
    ptr = jnp.asarray(ptr)
    ptr = ptr - ptr[:1]  # canonical-CSR rebase, as in ptr2ind
    positions = jnp.arange(capacity, dtype=ptr.dtype)
    ind = _expand_ptr(ptr, capacity)
    M = ptr.shape[0] - 1
    return jnp.where(positions < ptr[-1], ind, M).astype(ptr.dtype)
