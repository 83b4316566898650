"""Persistent XLA compilation cache shared by the command-line entry points.

A headline pipeline takes tens of seconds to compile; the cache keeps the
compiled programs across processes. ``JAX_COMPILATION_CACHE_DIR``, when it
is set, is the only cache directory: JAX reads it itself and nothing here
overrides it. Otherwise the cache lives in ``<checkout>/.jax_cache`` (listed
in ``.gitignore``).
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT_CACHE = Path(__file__).resolve().parents[1] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE))
    return str(CHECKOUT_CACHE)
