"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (the app, bench.py, tools/inverse_render.py
and the tests): when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it
itself and nothing is set here; otherwise the cache goes to the fixed
path ``<repo>/.jax_cache`` (listed in .gitignore). The path is part of
the cache key, so a fixed path is what lets a later process hit it.
"""
from __future__ import annotations

import os
from pathlib import Path

import jax

REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory (see the
    module docstring) and return that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return str(REPO_CACHE_DIR)
