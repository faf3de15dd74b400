"""Observability: named scopes, kernel timing, roofline accounting.

The reference ships no tracing/profiling at all (SURVEY.md §5); this module
wires the framework into ``jax.profiler`` (Perfetto/XProf traces) and gives a
roofline calculator for the benchmark harness, since the north-star metric is
HBM-roofline fraction.
"""
import contextlib
import time
from dataclasses import dataclass
from typing import Callable, Optional

import jax


@contextlib.contextmanager
def scope(name: str):
    """Named scope visible in XProf/Perfetto traces."""
    with jax.named_scope(name):
        yield


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/psp_trace"):
    """Capture a profiler trace around a block of device work."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> float:
    """Median-free simple wall timing of a jitted fn (seconds/iter)."""
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


@dataclass
class SpmmRoofline:
    """Byte model for CSR/COO SpMM."""
    nnz: int
    num_rows: int
    dim: int
    index_bytes: int = 4
    value_bytes: int = 4

    @property
    def bytes_moved(self) -> int:
        return (self.nnz * self.index_bytes * 2      # row + col
                + self.nnz * self.value_bytes        # edge values
                + self.nnz * self.dim * self.value_bytes   # gathered X
                + self.num_rows * self.dim * self.value_bytes)  # out

    def fraction(self, seconds: float, hbm_gbps: float) -> float:
        return (self.bytes_moved / (hbm_gbps * 1e9)) / seconds
