"""Where compiled programs are cached across processes.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; when it is set, nothing here
overrides it. Otherwise the cache goes to ``<repo>/.jax_cache`` — a fixed
path, because the path is part of the cache key.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def setup_compile_cache() -> str:
    """Place the persistent compile cache; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE_DIR))
    return str(REPO_CACHE_DIR)
