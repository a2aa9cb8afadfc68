"""Persistent XLA compilation cache for the entry points.

A cold start compiles the whole station: the per-type demod programs, the
fused steady step and the split dispatch.  JAX keeps compiled programs on
disk when it is given a cache directory, so a second run of the same
code reuses them.  Every entry point calls ``enable_compile_cache()``
before its first JAX computation.
"""

import os
from pathlib import Path

# fixed per checkout: the path is part of the cache key, so a directory
# that moves between runs never hits
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at a directory; returns
    the directory in use.

    ``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself
    and no other path is set here.  Otherwise the cache lives in
    ``<checkout>/.jax_cache``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
