"""Persistent XLA compilation cache for the CLI and script entry points.

A cold process compiles every pipeline program anew (tens of seconds at
the large geometries); JAX's persistent cache lets the next process load
them instead.  Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it
itself and this module sets nothing.  Otherwise the cache lives at the
fixed path `<checkout>/.jax_cache` (listed in .gitignore): a fixed path,
because the directory is part of what a cache hit has to match.

Library imports do NOT enable it (a library must not write to the
filesystem on import); only the entry points (`python -m
stereo_matchin_tpu`, bench.py, chip_smoke.py) call this.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable_compilation_cache(path: str | None = None) -> str:
    """Enable JAX's persistent compilation cache; returns the directory
    in use.  Safe to call repeatedly."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = path or DEFAULT_DIR
    os.makedirs(path, exist_ok=True)
    import jax

    jax.config.update("jax_compilation_cache_dir", path)
    # The default threshold skips programs that compile in under a
    # second; every pipeline program at a real geometry is above it.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
