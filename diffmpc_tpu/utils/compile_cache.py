"""Where the persistent XLA compilation cache lives.

One rule for every entry point (the benchmark, ``chip_smoke.py``, the
example CLIs): a cache directory the environment names in
``JAX_COMPILATION_CACHE_DIR`` is used as it is, and otherwise the cache
goes to the fixed ``<repo>/.jax_cache`` (listed in ``.gitignore``). A
fixed path matters: the path is part of the cache key, so a directory
that moves never hits.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> Optional[str]:
    """Point JAX's persistent compilation cache at ``<repo>/.jax_cache``
    unless ``JAX_COMPILATION_CACHE_DIR`` is set, in which case JAX already
    reads it and nothing is touched. Returns the directory set here, or
    None when the environment's choice stands."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
