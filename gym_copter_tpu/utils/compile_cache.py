"""Persistent XLA compilation cache for the repository's entry scripts.

The library never sets a cache on import; `chip_smoke.py`, `bench.py` and
the `scripts/bench_*.py` call `enable()` first thing.
"""

from __future__ import annotations

import os

ENV_VAR = 'JAX_COMPILATION_CACHE_DIR'
# a fixed path inside the checkout: the cache directory is part of what a
# later run must find again, so it is never built from a temporary name,
# a pid or the time
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), '.jax_cache')


def enable() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and this
    sets nothing; otherwise the cache lives at `<repo>/.jax_cache`."""
    import jax

    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    jax.config.update('jax_compilation_cache_dir', REPO_CACHE_DIR)
    return REPO_CACHE_DIR
