"""Native host-runtime loader: compiles the C++ kernels on first use and
exposes them through ctypes.

Replaces the reference's ahead-of-time custom-op extension build
(``setup_ops.py`` + ``paddle.utils.cpp_extension``) with a zero-dependency
lazy build: a single ``g++ -O3 -shared`` invocation cached next to the
source.  Everything degrades gracefully — if no compiler is present,
``available()`` is False and callers fall back to the numpy paths.
"""
import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "cpp", "psp_runtime.cpp")
_BUILD_DIR = os.path.join(_HERE, "build")
_SO = os.path.join(_BUILD_DIR, "libpsp_runtime.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


_build_error: Optional[str] = None


def _build() -> Optional[str]:
    global _build_error
    os.makedirs(_BUILD_DIR, exist_ok=True)
    if (os.path.exists(_SO)
            and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)):
        return _SO
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", _SO]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return _SO
    except subprocess.CalledProcessError as e:  # keep the compiler's say
        _build_error = (e.stderr or b"").decode("utf-8", "replace")[-2000:]
        return None
    except Exception as e:  # noqa: BLE001
        _build_error = f"{type(e).__name__}: {e}"
        return None


def build_error() -> Optional[str]:
    """Why the lazy native build failed (None if it succeeded or was
    never attempted) — surfaced by the slow-path sampler warning."""
    return _build_error


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so = _build()
        if so is None:
            return None
        lib = ctypes.CDLL(so)

        lib.psp_ind2ptr.argtypes = [_i64p, ctypes.c_int64, ctypes.c_int64,
                                    _i64p]
        lib.psp_ptr2ind.argtypes = [_i64p, ctypes.c_int64, _i64p]
        lib.psp_lexsort_rowcol.argtypes = [_i64p, _i64p, ctypes.c_int64,
                                           _i64p]
        lib.psp_sample_adj.restype = ctypes.c_int64
        lib.psp_sample_adj.argtypes = [
            _i64p, _i64p, _i64p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_uint64, _i64p, _i64p, _i64p, _i64p,
            ctypes.POINTER(ctypes.c_int64)]
        lib.psp_rcm.argtypes = [_i64p, _i64p, ctypes.c_int64, _i64p]
        lib.psp_partition.argtypes = [_i64p, _i64p, ctypes.c_int64,
                                      ctypes.c_int64, _i64p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------
# numpy-facing wrappers
# ---------------------------------------------------------------------------
def sample_adj(rowptr: np.ndarray, col: np.ndarray, subset: np.ndarray,
               num_neighbors: int, replace: bool, seed: int):
    """Native sampler; returns (rowptr, col, e_id, n_id) int64 arrays."""
    lib = _load()
    assert lib is not None
    rowptr = np.ascontiguousarray(rowptr, np.int64)
    col = np.ascontiguousarray(col, np.int64)
    subset = np.ascontiguousarray(subset, np.int64)
    S = len(subset)
    deg = rowptr[subset + 1] - rowptr[subset]
    capacity = int(deg.sum()) if num_neighbors < 0 else int(
        np.minimum(deg, num_neighbors).sum() if not replace
        else S * num_neighbors)
    capacity = max(capacity, 1)

    out_rowptr = np.zeros(S + 1, np.int64)
    out_col = np.zeros(capacity, np.int64)
    out_eid = np.zeros(capacity, np.int64)
    out_nid = np.zeros(S + capacity, np.int64)
    num_nodes = ctypes.c_int64(0)

    n_edges = lib.psp_sample_adj(rowptr, col, subset, S, num_neighbors,
                                 int(replace), seed, out_rowptr, out_col,
                                 out_eid, out_nid,
                                 ctypes.byref(num_nodes))
    return (out_rowptr, out_col[:n_edges], out_eid[:n_edges],
            out_nid[:num_nodes.value])


def lexsort_rowcol(row: np.ndarray, col: np.ndarray) -> np.ndarray:
    lib = _load()
    assert lib is not None
    row = np.ascontiguousarray(row, np.int64)
    col = np.ascontiguousarray(col, np.int64)
    perm = np.zeros(len(row), np.int64)
    lib.psp_lexsort_rowcol(row, col, len(row), perm)
    return perm


def rcm(rowptr: np.ndarray, col: np.ndarray) -> np.ndarray:
    lib = _load()
    assert lib is not None
    rowptr = np.ascontiguousarray(rowptr, np.int64)
    col = np.ascontiguousarray(col, np.int64)
    N = len(rowptr) - 1
    perm = np.zeros(N, np.int64)
    lib.psp_rcm(rowptr, col, N, perm)
    return perm


def partition_clusters(rowptr: np.ndarray, col: np.ndarray,
                       num_parts: int) -> np.ndarray:
    lib = _load()
    assert lib is not None
    rowptr = np.ascontiguousarray(rowptr, np.int64)
    col = np.ascontiguousarray(col, np.int64)
    N = len(rowptr) - 1
    cluster = np.zeros(N, np.int64)
    lib.psp_partition(rowptr, col, N, num_parts, cluster)
    return cluster


def compat_check(verbose: bool = False) -> dict:
    """Runtime capability probe — the analogue of the reference's
    import-time CUDA version-parity gate
    (``/root/reference/paddle_sparse/__init__.py:17-32`` comparing the
    custom-op extension's compile-time ``CUDA_VERSION`` against the
    framework's).  Nothing here is compiled against a driver, so the check
    reports what backs each subsystem instead of hard-failing:

    * ``jax`` / ``jaxlib`` versions and the default platform,
    * the SpMM kernel route on that platform (``"triton"`` on the GPU,
      ``"interpret"`` on the CPU, ``None`` where there is none),
    * whether the C++ host runtime built (falls back to numpy otherwise).
    """
    import jax
    import jaxlib

    from ..ops.kernels.spmm_pallas import interpret_mode
    platform = jax.default_backend()
    try:
        route = "interpret" if interpret_mode(platform) else "triton"
    except NotImplementedError:
        route = None
    info = {
        "jax": jax.__version__,
        "jaxlib": jaxlib.__version__,
        "platform": platform,
        "kernel_route": route,
        "native_runtime": available(),
    }
    if verbose:  # pragma: no cover
        for k, v in info.items():
            print(f"{k}: {v}")
    return info
