"""Persistent XLA compilation cache.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, the cache lives there and
nowhere else.  Otherwise it lives at the fixed path
``<checkout>/.jax_cache/<backend>`` (a fixed path because the path is part
of the cache's key; one directory per backend because CPU executables are
machine-specific and must not mix with GPU ones).
"""

from __future__ import annotations

import os

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compilation_cache() -> str:
    """Idempotently enable the persistent compilation cache; returns its
    directory."""
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = os.path.join(_CHECKOUT, ".jax_cache",
                                 jax.default_backend())
        os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    return cache_dir
