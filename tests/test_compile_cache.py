"""Placement of the persistent compile cache (utils/compile_cache.py)."""

import jax

from rs_bann_tpu.utils import compile_cache as cc


def _restore(value):
    jax.config.update("jax_compilation_cache_dir", value)


def test_env_var_wins(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert cc.setup_compile_cache() == str(tmp_path)
        # nothing set in code: JAX reads the variable itself
        assert jax.config.jax_compilation_cache_dir == before
    finally:
        _restore(before)


def test_default_is_repo_dot_jax_cache(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = cc.setup_compile_cache()
        assert path.endswith("/.jax_cache")
        assert cc.REPO_CACHE_DIR.parent == cc.Path(__file__).resolve().parents[1]
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        _restore(before)
