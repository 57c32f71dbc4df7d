"""Persistent XLA compilation cache placement.

One helper, called by every entry point (chip_smoke.py, bench.py,
bench_e2e.py, the CLI): when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX
reads it itself and nothing here overrides it; otherwise the cache lives
at ``<checkout>/.jax_cache``.  The path is fixed — never derived from a
temporary name, a process id or the time — because it is part of what
makes a later process find an earlier one's compiled programs.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def cache_dir() -> str:
    """The directory the compile cache uses: the environment's, else
    DEFAULT_DIR."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at cache_dir(); returns
    it.  Sets no directory in code when the environment names one."""
    import jax

    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    # Cache every program that took measurable time to compile (the
    # default skips anything under a second; the tracker's step compiles
    # in seconds on a cold process).
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return cache_dir()
