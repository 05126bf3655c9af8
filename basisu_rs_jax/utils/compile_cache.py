"""Where the persistent JAX compilation cache lives.

JAX reads JAX_COMPILATION_CACHE_DIR itself; when it is set, that directory
is the only cache and nothing here overrides it.  Otherwise entry points
(the CLI, bench.py, chip_smoke.py, the test suite) put the cache at the
fixed `.jax_cache/` of this checkout: the path is part of the cache key, so
a directory that moves between runs would never hit.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> str:
    return os.environ.get(ENV) or str(DEFAULT_DIR)


def configure() -> str:
    """Point JAX's persistent compilation cache at cache_dir(); returns it.
    Call before the first compilation."""
    import jax

    path = cache_dir()
    if not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
