"""Where the persistent XLA compilation cache lives.

Every entry point (``pprx.cli``, ``bench.py``, ``chip_smoke.py``, the
scripts) calls :func:`enable_compile_cache` once, before anything compiles.
"""

from __future__ import annotations

import os
from pathlib import Path

# A fixed directory inside the checkout (listed in .gitignore). The path is
# part of the cache key, so it must not move between runs.
DEFAULT_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and this
    sets no other directory. Otherwise the cache goes to
    ``DEFAULT_CACHE_DIR``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)
