"""Persistent XLA compilation cache setup.

The bf16 adversarial step graph takes long enough to compile that every
measurement entry point (``bench.py``, ``chip_smoke.py``) enables JAX's
persistent compilation cache before first device use. The rule:

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself; nothing here
  sets another directory.
* Unset: a fixed directory inside the checkout (``<repo>/.jax_cache``,
  listed in ``.gitignore``). The path is part of what makes a cache
  entry findable again, so it must not move between runs.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir() -> str:
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_persistent_cache(min_compile_time_secs: int = 5) -> str:
    """Turn on JAX's persistent compilation cache. Call before the first
    jit/compile. Returns the directory in use."""
    import jax

    if not os.environ.get(ENV_VAR):
        os.makedirs(DEFAULT_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_time_secs)
    return cache_dir()
