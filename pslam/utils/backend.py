"""Persistent compilation cache.

The system compiles a handful of shape-bucketed backend programs (local BA
edge/point buckets, fuse candidate buckets) as the map grows, and each cold
compile lands on the keyframe frame that first hits its bucket. JAX's
persistent cache makes every program compile at most once per cache
directory; later runs replay from disk.
"""

from __future__ import annotations

import os

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def compile_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``
    (a fixed path: the directory is part of the cache key)."""
    return os.environ.get(CACHE_ENV) or os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set JAX already reads it, and no
    other directory is set here.
    """
    import jax

    path = compile_cache_dir()
    if not os.environ.get(CACHE_ENV):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
