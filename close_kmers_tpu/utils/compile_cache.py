"""Where compiled XLA programs persist between processes."""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its
    directory.  When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already
    uses it and nothing else is set here; otherwise the cache lives at
    ``<checkout>/.jax_cache``, a fixed path, so every process of this
    checkout finds what the others compiled."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    path = os.path.join(CHECKOUT, ".jax_cache")
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
