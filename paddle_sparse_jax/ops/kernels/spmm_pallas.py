"""CSR SpMM kernel for NVIDIA GPUs, written in Pallas for the Triton route.

``out[r] = sum_{e in [rowptr[r], rowptr[r+1])} value[e] * x[col[e]]``

Each program owns ``BR`` consecutive rows and one ``BK``-wide tile of the
feature dimension K (both powers of two).  It reads its own rowptr
entries (no scalar prefetch, no work-item list), walks each row's edges
in ``BE``-edge chunks, gathers the ``x`` rows by ``col`` inside the
kernel, scales them by ``value`` and accumulates in f32 registers.  Each
output row is stored once; no atomics, nothing carried between
programs.  Pipelining comes from ``CompilerParams(num_warps,
num_stages)``.

The fused gather is the reason to have a kernel: the plain XLA
formulation (gather x value, then a sorted ``segment_sum``) writes and
re-reads an nnz x K product stream, which at ogbn-products scale
(123.7M nnz, K=256, f32) is ~127 GB, more than the card holds.  The
kernel reads each gathered row once and writes only the output.

``col=None`` reduces a materialised row-sorted stream (``x`` row ``e`` is
edge ``e``): the same kernel serves :func:`segment_rows_matmul`.

Device rule (:func:`interpret_mode`): the CPU runs the kernel in Pallas
interpret mode (tests), the GPU runs the compiled Triton route, and any
other platform raises.

The reference has no SpMM (unsupported list, /root/reference/README.md:45);
the functional contract is upstream's, /root/reference/README.md:267-300.
"""
import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt


def _lowering_platform() -> str:
    """Platform that jitted code lowers for: a ``jax.default_device``
    override first (a virtual CPU mesh inside a GPU process), else the
    default backend."""
    dev = jax.config.jax_default_device
    if dev is not None:
        return getattr(dev, "platform", None) or str(dev)
    return jax.default_backend()


def interpret_mode(platform: Optional[str] = None) -> bool:
    """The device rule for every Pallas kernel of this package: True
    (interpret) on the CPU, False (compiled Triton route) on the GPU.
    Any other platform has no kernel route and raises."""
    platform = platform or _lowering_platform()
    if platform == "cpu":
        return True
    if platform in ("gpu", "cuda"):
        return False
    raise NotImplementedError(
        f"no Pallas kernel route for platform {platform!r} "
        "(the CPU interprets, the GPU compiles through Triton)")


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def kernel_config(K: int):
    """Static tile sizes ``(BR, BE, BK, num_warps, num_stages)`` for
    feature width ``K``: the K tile covers the row up to 256 lanes, the
    edge chunk keeps a BE x BK gather tile near 4096 elements."""
    BK = min(256, max(16, _next_pow2(K)))
    BE = max(16, min(64, 4096 // BK))
    return 8, BE, BK, 4, 2


def _csr_kernel(*refs, has_col: bool, has_val: bool, has_y: bool, BR: int,
                BE: int, BK: int, K: int, N: int, M: int, L: int):
    rest = list(refs)
    rowptr_ref = rest.pop(0)
    col_ref = rest.pop(0) if has_col else None
    val_ref = rest.pop(0) if has_val else None
    x_ref = rest.pop(0)
    y_ref = rest.pop(0) if has_y else None
    out_ref = rest.pop(0)
    dv_ref = rest.pop(0) if has_y else None
    i = pl.program_id(0)
    j = pl.program_id(1)
    lanes = jnp.arange(BE, dtype=jnp.int32)
    k0 = j * BK
    kmask = (k0 + jnp.arange(BK, dtype=jnp.int32)) < K
    if K % BK == 0:
        kidx = pl.ds(k0, BK)                    # contiguous, vectorised
    else:
        kidx = jnp.minimum(k0 + jnp.arange(BK, dtype=jnp.int32), K - 1)

    def row_body(t, carry):
        r = i * BR + t
        rs = jnp.minimum(r, M - 1)
        start = rowptr_ref[jnp.minimum(r, M)]
        end = rowptr_ref[jnp.minimum(r + 1, M)]
        nchunks = (end - start + (BE - 1)) // BE
        if has_y:   # this row's own dense row, dotted with every gather
            y_row = jnp.where(kmask, y_ref[rs, kidx].astype(jnp.float32),
                              0.0)

        def chunk_body(c, acc):
            e = start + c * BE + lanes
            emask = e < end
            # clamped indices keep every access in bounds; masked lanes
            # contribute zero through ``scale``
            ec = jnp.minimum(e, L - 1)
            src = (jnp.clip(col_ref[ec], 0, N - 1) if has_col
                   else jnp.minimum(ec, N - 1))
            scale = emask.astype(jnp.float32)
            if has_val:
                scale = jnp.where(emask, val_ref[ec].astype(jnp.float32),
                                  0.0)
            if K % BK == 0:
                rows = x_ref[src, kidx]
            else:
                rows = x_ref[src[:, None], kidx[None, :]]
            rows = rows.astype(jnp.float32)
            if has_y:
                plt.store(dv_ref.at[pl.ds(start + c * BE, BE)],
                          (rows * y_row[None, :]).sum(axis=1), mask=emask)
            return acc + rows * scale[:, None]

        acc = jax.lax.fori_loop(0, nchunks, chunk_body,
                                jnp.zeros((BE, BK), jnp.float32))
        plt.store(out_ref.at[rs, pl.ds(k0, BK)], acc.sum(axis=0),
                  mask=kmask & (r < M))
        return carry

    jax.lax.fori_loop(0, BR, row_body, 0)


@functools.partial(jax.jit, static_argnames=("interpret", "config"))
def _csr_call(rowptr, col, value, x, y, *, interpret: bool, config):
    BR, BE, BK, num_warps, num_stages = config
    M = rowptr.shape[0] - 1
    N, K = x.shape
    L = col.shape[0] if col is not None else N
    operands = [rowptr.astype(jnp.int32)]
    if col is not None:
        operands.append(col.astype(jnp.int32))
    if value is not None:
        operands.append(value)
    operands.append(x)
    out_shape = [jax.ShapeDtypeStruct((M, K), jnp.float32)]
    if y is not None:
        assert BK >= K, "the fused per-edge dot needs the whole row"
        operands.append(y)
        out_shape.append(jax.ShapeDtypeStruct((L,), jnp.float32))
    kernel = functools.partial(
        _csr_kernel, has_col=col is not None, has_val=value is not None,
        has_y=y is not None, BR=BR, BE=BE, BK=BK, K=K, N=N, M=M, L=L)
    out = pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=(pl.cdiv(M, BR), pl.cdiv(K, BK)),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=num_warps,
                                           num_stages=num_stages),
        interpret=interpret,
        name="csr_spmm" if y is None else "csr_spmm_sddmm",
    )(*operands)
    return out if y is not None else out[0]


def csr_spmm(rowptr: jax.Array, col: Optional[jax.Array],
             value: Optional[jax.Array], x: jax.Array, *,
             interpret: Optional[bool] = None) -> jax.Array:
    """Fused CSR SpMM (sum): ``(M, K)`` float32 from ``rowptr`` (M+1,),
    ``col`` (L,) or ``None`` (edge ``e`` reads ``x[e]``), ``value`` (L,)
    or ``None`` (ones) and ``x`` (N, K).

    ``rowptr`` entries are clipped into ``[0, L]``; ``col`` entries are
    clipped into ``[0, N)`` (padding cols one past the end read the last
    row and must carry a zero value or land in a dead row).  The output
    is float32 whatever the stream dtype: accumulation is f32.
    ``interpret=None`` applies :func:`interpret_mode`."""
    M = int(rowptr.shape[0]) - 1
    N, K = int(x.shape[0]), int(x.shape[1])
    L = int(col.shape[0]) if col is not None else N
    if M <= 0 or K == 0 or L == 0 or N == 0:
        return jnp.zeros((max(M, 0), K), jnp.float32)
    if interpret is None:
        interpret = interpret_mode()
    rowptr = jnp.clip(rowptr.astype(jnp.int32), 0, L)
    return _csr_call(rowptr, col, value, x, None, interpret=bool(interpret),
                     config=kernel_config(K))


# widest K the fused transpose + SDDMM pass keeps in one program
FUSED_SDDMM_MAX_K = 256


def csr_spmm_sddmm(rowptr: jax.Array, col: jax.Array,
                   value: Optional[jax.Array], g: jax.Array, y: jax.Array,
                   *, interpret: Optional[bool] = None):
    """One pass of the SpMM backward over A^T stored as CSR: returns
    ``(d_x, dv)`` with ``d_x = csr_spmm(rowptr, col, value, g)`` and, per
    edge ``e`` of row ``r``, ``dv[e] = g[col[e]] . y[r]`` — the value
    gradient shares the gathered ``g`` rows with the transpose SpMM
    instead of gathering two more (nnz, K) streams.  ``K`` must be at most
    :data:`FUSED_SDDMM_MAX_K`; ``dv`` is float32 in this CSR's edge
    order (entries past ``rowptr[-1]`` are unspecified)."""
    M = int(rowptr.shape[0]) - 1
    N, K = int(g.shape[0]), int(g.shape[1])
    L = int(col.shape[0])
    assert 0 < K <= FUSED_SDDMM_MAX_K and y.shape == (M, K)
    if M <= 0 or L == 0 or N == 0:
        return jnp.zeros((max(M, 0), K), jnp.float32), jnp.zeros(
            (L,), jnp.float32)
    if interpret is None:
        interpret = interpret_mode()
    rowptr = jnp.clip(rowptr.astype(jnp.int32), 0, L)
    # kernel_config's K tile covers any K <= 256 in one program
    return _csr_call(rowptr, col, value, g, y, interpret=bool(interpret),
                     config=kernel_config(K))


def segment_rows_matmul(products: jax.Array, row: Optional[jax.Array],
                        rowptr: jax.Array, num_rows: int,
                        interpret: Optional[bool] = None) -> jax.Array:
    """Row reduction of a materialised row-sorted stream:
    ``out[m] = sum_{rowptr[m]<=e<rowptr[m+1]} products[e]``.

    ``rowptr`` must hold at least ``num_rows + 1`` entries (extra ones
    are ignored); ``row`` is accepted for API compatibility and unused.
    Returns (num_rows, K) float32."""
    del row
    return csr_spmm(rowptr[:num_rows + 1], None, None, products,
                    interpret=interpret)


def _stream_env():
    import os
    return os.environ.get("PSP_SPMM_STREAM", "f32")


# Read ONCE at import: jit caches are not keyed on the environment, so a
# mid-process flip of PSP_SPMM_STREAM must not change traced behavior.
# Callers that want a per-structure choice thread an explicit ``stream``
# through the plan (``SpmmPlan.stream``) instead.
_STREAM_DEFAULT = _stream_env()


def _product_dtype(value, x, stream: Optional[str] = None):
    """Stream dtype: bf16 when BOTH operands are bf16 (an f32 value paired
    with bf16 x must not silently drop to bf16) OR when ``stream ==
    "bf16"`` opts in explicitly; f32 otherwise.

    ``stream=None`` falls back to the process-start value of
    ``PSP_SPMM_STREAM`` (pass ``stream`` explicitly for a per-call
    choice).  The bf16 stream halves the dominant bytes (the random x-row
    gather) at ~3 decimal digits of per-element precision; accumulation
    stays f32 inside the kernel either way."""
    common = x.dtype if value is None else jnp.promote_types(value.dtype,
                                                             x.dtype)
    if common == jnp.bfloat16:
        return jnp.bfloat16
    if common == jnp.float32 and (stream or _STREAM_DEFAULT) == "bf16":
        return jnp.bfloat16
    return jnp.float32


def sddmm_dot_chunked(row: jax.Array, col: jax.Array, g: jax.Array,
                      x: jax.Array, target_bytes: int = 512 * 1024 * 1024,
                      out_dtype=None) -> jax.Array:
    """Per-edge sampled dot ``out[e] = g[row[e]] . x[col[e]]`` computed in
    bounded edge windows (the value-gradient of SpMM at scales where the
    two gathered (nnz, K) streams cannot be materialized whole)."""
    nnz = row.shape[0]
    K = g.shape[-1]
    edge_chunk = max(1024, target_bytes // (2 * K * 4))
    EC = min(edge_chunk, max(1, nnz))
    nchunks = -(-nnz // EC)
    pad = nchunks * EC - nnz
    row_p = jnp.pad(row, (0, pad))
    col_p = jnp.pad(col, (0, pad))

    def chunk_fn(c):
        e0 = c * EC
        r = jax.lax.dynamic_slice(row_p, (e0,), (EC,))
        cl = jax.lax.dynamic_slice(col_p, (e0,), (EC,))
        gr = jnp.take(g, r, axis=0, mode="clip").astype(jnp.float32)
        xc = jnp.take(x, cl, axis=0, mode="clip").astype(jnp.float32)
        return (gr * xc).sum(axis=1)

    out = jax.lax.map(chunk_fn, jnp.arange(nchunks, dtype=jnp.int32))
    out = out.reshape(nchunks * EC)[:nnz]
    return out.astype(out_dtype or g.dtype)


def spmm_pallas(rowptr: jax.Array, col: jax.Array,
                value: Optional[jax.Array], x: jax.Array,
                row: Optional[jax.Array] = None,
                interpret: Optional[bool] = None,
                stream: Optional[str] = None) -> jax.Array:
    """Full SpMM (sum-reduce) through the fused kernel, forward only
    (gradients are wired by ``ops.spmm``).  Output follows the promoted
    input dtype; accumulation is f32 inside the kernel."""
    del row
    pdt = _product_dtype(value, x, stream)
    out = csr_spmm(rowptr, col,
                   None if value is None else value.astype(pdt),
                   x.astype(pdt), interpret=interpret)
    common = x.dtype if value is None else jnp.promote_types(value.dtype,
                                                             x.dtype)
    return out.astype(common)
