"""Persistent XLA compilation cache placement, shared by every entry point
(the CLI, bench.py, chip_smoke.py and the scripts).

- ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it on import; nothing is
  set here, so the cache lives there and nowhere else.
- ``PANORAMA_TPU_NO_CACHE`` set (non-empty): no persistent cache.
- Otherwise: ``<checkout>/.jax_cache`` (listed in .gitignore). A fixed
  path matters because the path is part of the cache key.
"""
from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir() -> str | None:
    """The directory this module would point JAX at, or None when it
    leaves the choice alone (env var set, or caching disabled)."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    if os.environ.get("PANORAMA_TPU_NO_CACHE"):
        return None
    return os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str | None:
    """Point JAX's persistent compilation cache at ``cache_dir()``.
    Returns the directory set, or None if nothing was set."""
    path = cache_dir()
    if path is None:
        return None
    import jax

    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
