"""Persistent JAX compilation cache at a fixed path.

The next run finds what this one compiled only if it looks in the same
place, so the path does not depend on the host: ``JAX_COMPILATION_CACHE_DIR``
wins when it is set, and otherwise the cache lives at
``<checkout>/.jax_cache`` (listed in ``.gitignore``).
"""

from __future__ import annotations

import os

#: the directory that holds the ``annembed_tpu`` package
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` if set, else ``<checkout>/.jax_cache``."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".jax_cache"))


def enable_persistent_cache() -> str:
    """Point JAX at :func:`cache_dir`; returns the directory in use."""
    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    import jax
    jax.config.update("jax_compilation_cache_dir", path)
    return path
