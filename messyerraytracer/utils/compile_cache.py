"""Persistent XLA compile cache location for the entry-point scripts.

``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as it is: JAX reads
it itself and nothing else is configured here.  Otherwise the cache lives
at the fixed ``<checkout>/.jax_cache`` (listed in ``.gitignore``), so a
second process on the same checkout finds the first one's compiles.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; returns it."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
