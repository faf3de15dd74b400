"""Persistent compilation cache location.

``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as it is and no
other directory is set in code.  When it is unset, the cache lives at a
fixed directory inside the checkout (``.jax_cache/``, ignored by git): the
path is part of the cache key, so a directory that moves never hits.
"""
import os

CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def compile_cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at :func:`compile_cache_dir` and cache
    every compilation; returns the directory."""
    import jax
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
