"""Persistent XLA compilation cache, shared by every entry point.

A run compiles its radiative and convective loop programs once; with the
cache, the next process that runs the same configuration (the next outer
iteration of a chemistry-coupling loop, the next benchmark) loads them
instead of compiling again.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"

# <checkout>/.jax_cache: a fixed path, so every process of a checkout
# finds what the others compiled
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and no
    directory is set here.  Otherwise the cache goes to `DEFAULT_DIR`.
    Call before the first compilation of the process.
    """
    import jax

    if os.environ.get(ENV):
        return os.environ[ENV]
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
