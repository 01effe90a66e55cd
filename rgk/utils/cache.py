"""Where JAX keeps its persistent compilation cache."""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its path.

    If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and this
    sets nothing.  Otherwise the cache lives at `<checkout>/.jax_cache`
    (git-ignored): a fixed path, because the path is part of the
    cache's key."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
