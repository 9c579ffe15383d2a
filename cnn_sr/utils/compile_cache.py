"""Where JAX keeps its persistent compilation cache.

Compiling the conv stacks for a new image shape takes seconds; a cache
that survives the process turns the second run of a command into a
load. The cache directory is part of the cache's key, so it lives at a
fixed path: ``<repo>/.jax_cache`` (git-ignored), never a temp, pid or
time-based one.
"""

from __future__ import annotations

import os

import jax

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(_REPO_ROOT, ".jax_cache")


def configure_compile_cache() -> str:
    """Enable the persistent compile cache; returns its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here. Otherwise the cache goes to ``DEFAULT_DIR``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
