"""Persistent XLA compilation cache setup.

Compiling the solver and growth programs is a large part of a cold run;
caching by shape makes every later run start from compiled code. Callers
that own a process (CLI, benches, the smoke check, the test suite) call
:func:`enable_compilation_cache` before the first compilation.

One rule picks the directory: ``JAX_COMPILATION_CACHE_DIR`` when it is
set (JAX reads it itself, so nothing is set here), otherwise the fixed
``<repo>/.jax_cache``. A fixed path matters: the path is part of what a
cache hit needs.
"""

from __future__ import annotations

import os

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(_REPO_ROOT, ".jax_cache")


def enable_compilation_cache() -> str:
    """Turn the persistent cache on and return its directory."""
    import jax
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return DEFAULT_CACHE_DIR
