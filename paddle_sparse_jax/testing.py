"""Test-matrix helpers (reference parity: ``paddle_sparse/testing.py``).

The dtype x device grid mirrors the reference: float16/32/64 + int32/64 + bf16
(reference gates bf16 on the paddle_scatter version; here it is always
available).  float64 coverage requires jax x64 mode, which the test conftest
enables; when x64 is off those dtypes are skipped rather than silently
downcast.
"""
from typing import List

import jax
import jax.numpy as jnp
import pytest

dtypes: List = [jnp.float16, jnp.bfloat16, jnp.float32, jnp.float64,
                jnp.int32, jnp.int64]
grad_dtypes: List = [jnp.float32, jnp.float64]

# the conformance grid runs on the CPU; the GPU path is exercised by
# chip_smoke.py (no device probe at import: test collection must not
# depend on the attached hardware)
devices: List[str] = ["cpu"]


def tensor(data, dtype, device: str = "cpu"):
    arr = jnp.asarray(data, dtype=dtype)
    return jax.device_put(arr, jax.devices(device)[0])


def maybe_skip_testing(dtype, device: str) -> None:
    if dtype in (jnp.float64, jnp.int64) and not jax.config.jax_enable_x64:
        pytest.skip("x64 mode disabled; skipping 64-bit dtype")


def set_testing_device(device: str) -> None:
    jax.config.update("jax_default_device", jax.devices(device)[0])
