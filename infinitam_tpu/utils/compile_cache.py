"""Persistent XLA compilation cache, shared by every entry point.

Compiling the frame program takes most of a cold start, so each entry point
(the CLI, the viewer, bench.py, chip_smoke.py, the test suite) calls
`enable_compile_cache()` before its first jit. The cache lives where
`JAX_COMPILATION_CACHE_DIR` says; when that is unset, in `.jax_cache/` at the
root of the checkout (git-ignored). The path is part of the cache key, so it
is fixed rather than temporary.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn the persistent cache on and return its directory. A directory
    given by the environment is left to JAX, which reads the variable
    itself; no other directory is set then."""
    env_dir = os.environ.get(ENV_VAR)
    if not env_dir:
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return env_dir or DEFAULT_DIR
