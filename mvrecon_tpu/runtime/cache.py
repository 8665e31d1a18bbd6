"""Persistent XLA compilation cache.

Every CLI/bench entry point enables the on-disk cache so recompiles are
paid once per program shape, not once per process. The rule:

- ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself and this module
  sets no directory, so entries land in exactly that directory;
- unset: one fixed directory inside the checkout (``<repo>/.jax_cache``,
  listed in ``.gitignore``). The path is part of the cache key, so it
  must not move between runs (no hash, pid or time in it);
- **CPU backend: the cache stays off.** XLA:CPU entries embed AOT host
  machine code, and loading entries serialized on a host with different
  CPU features can fail ("Machine type used for XLA:CPU compilation
  doesn't match"); CPU compiles are cheap, so the cache buys nothing.
"""

from __future__ import annotations

import os

import jax

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compilation_cache() -> str | None:
    """Enable the on-disk compile cache for non-CPU backends; returns the
    directory in use (None on the CPU backend)."""
    if jax.default_backend() == "cpu":
        return None
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return jax.config.jax_compilation_cache_dir
