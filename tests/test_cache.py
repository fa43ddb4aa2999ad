"""Compile-cache location (utils/cache.py): the environment variable
wins, otherwise a fixed directory in the checkout."""

import os

import jax

from annembed_tpu.utils import cache


def test_cache_dir_env_var_wins(tmp_path, monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert cache.cache_dir() == str(tmp_path / "c")
    before = jax.config.jax_compilation_cache_dir
    try:
        assert cache.enable_persistent_cache() == str(tmp_path / "c")
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "c")
        assert (tmp_path / "c").is_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cache.cache_dir() == os.path.join(repo, ".jax_cache")
    # the same path on every call, so the next run finds the cache
    assert cache.cache_dir() == cache.cache_dir()
