"""Test bootstrap: the CPU backend with 8 virtual devices (multi-device
sharding tests run on a virtual mesh — SURVEY.md §4) and x64 enabled so
the reference's float64/int64 conformance matrix is coverable.  Pallas
kernels run in interpret mode here.

``PSP_TESTS_ON_GPU=1`` leaves the platform to JAX instead: that is how
``chip_smoke.py`` runs the card-only tests (marker ``gpu``) on the card.
Which tests exist never depends on the hardware; the ``gpu`` fixture
skips at run time."""
import os

ON_GPU = os.environ.get("PSP_TESTS_ON_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

from paddle_sparse_jax.cache import enable_compile_cache  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
# persistent compile cache: the eager facade triggers many small compiles
enable_compile_cache()
