"""The persistent compilation cache helper shared by the entry points."""

import os

import jax

from helios_tpu import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_from_environment(monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, JAX's own reading of it stands:
    the helper sets no directory."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV, "/elsewhere/cache")
    assert compile_cache.enable_compile_cache() == "/elsewhere/cache"
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
