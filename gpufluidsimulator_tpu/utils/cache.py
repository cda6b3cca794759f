"""Persistent XLA compilation cache.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this module
sets no other path.  Otherwise the cache lives at one fixed path inside the
checkout, ``<repo>/.jax_cache`` (listed in .gitignore).  Call ``enable()``
before the first jit; the CLI, the benchmark and the test harness do.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory the compile cache uses under the rule above."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable() -> str:
    import jax

    path = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
