"""Feature flags and shared type aliases.

Analogue of the reference's optional-dependency probe
(``/root/reference/paddle_sparse/typing.py:3-11``): instead of probing for
``pyg_lib`` it reports the JAX settings that matter here.  The platform
and kernel route are reported by ``runtime.compat_check``.
"""
from typing import Tuple, Union

import jax
import numpy as np

# True when 64-bit dtypes are enabled (tests enable this; the GPU path
# runs int32/f32/bf16 and leaves this off).
def with_x64() -> bool:
    return bool(jax.config.jax_enable_x64)


Shape2D = Tuple[int, int]
ArrayLike = Union[jax.Array, np.ndarray, list, tuple]
