"""Persistent compile cache rule (``utils/compile_cache.py``)."""

import jax
import pytest

from adversarial_learning_on_pointclouds.utils import compile_cache


@pytest.fixture
def restore_cache_config():
    """Put the global cache settings back after a test changes them."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_cache_dir_env_override(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    assert compile_cache.cache_dir() == str(tmp_path / "cc")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    # Unset: a fixed directory inside the checkout.
    repo = compile_cache.os.path.dirname(compile_cache.os.path.dirname(
        compile_cache.os.path.dirname(compile_cache.__file__)))
    assert compile_cache.cache_dir() == f"{repo}/.jax_cache"


def test_enable_with_env_sets_no_other_dir(monkeypatch, tmp_path,
                                           restore_cache_config):
    """With the variable set, JAX reads it itself: the code leaves
    ``jax_compilation_cache_dir`` alone and creates nothing."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    jax.config.update("jax_compilation_cache_dir", None)
    assert compile_cache.enable_persistent_cache() == str(tmp_path / "env")
    assert jax.config.jax_compilation_cache_dir is None
    assert not (tmp_path / "env").exists()


def test_enable_without_env_uses_fixed_checkout_dir(monkeypatch, tmp_path,
                                                    restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    fixed = tmp_path / "repo" / ".jax_cache"
    monkeypatch.setattr(compile_cache, "DEFAULT_DIR", str(fixed))
    assert compile_cache.enable_persistent_cache(3) == str(fixed)
    assert fixed.is_dir()
    assert jax.config.jax_compilation_cache_dir == str(fixed)
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 3
