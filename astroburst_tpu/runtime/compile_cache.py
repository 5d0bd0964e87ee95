"""Persistent XLA compilation cache.

A cold start compiles every program of the main path; the persistent
cache lets the next process reuse them. The cache's location is part
of its key, so it must not move between runs: ``JAX_COMPILATION_CACHE_DIR``
when the environment sets it (JAX reads it itself, and nothing here
overrides it), otherwise one fixed directory inside the checkout,
listed in ``.gitignore``.

Entry points (``chip_smoke.py``, ``bench.py``, ``bench_ops.py`` and the
import of ``astroburst_tpu.api``) call :func:`enable_compile_cache`
before their first compile. Importing this module configures nothing.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> str:
    """The directory the cache lives in: the environment's choice, or
    the checkout's fixed default."""
    return os.environ.get(ENV_VAR) or str(DEFAULT_DIR)


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at :func:`cache_dir` and return it.
    Where the environment names the directory, JAX already uses it and
    no other path is set."""
    import jax

    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
