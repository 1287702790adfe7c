"""Persistent XLA compilation cache: one place decides where it lives.

``JAX_COMPILATION_CACHE_DIR``, when set, is the cache: JAX reads it
itself, and nothing here overrides it.  Otherwise the cache is
``<checkout>/.jax_cache`` (listed in ``.gitignore``).  A fixed path
matters: the path is part of the cache key, so a directory that moves
never hits.
"""

from __future__ import annotations

import os
import pathlib

import jax

__all__ = ["CHECKOUT_CACHE", "enable_compile_cache"]

CHECKOUT_CACHE = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE))
    return str(CHECKOUT_CACHE)
