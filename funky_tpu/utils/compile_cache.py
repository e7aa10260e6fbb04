"""Persistent XLA compile cache at one fixed place.

Every launcher (chip_smoke.py, bench.py, demo.py, the test suite) calls
`enable_compile_cache()` before its first compile. Where
JAX_COMPILATION_CACHE_DIR is set, JAX already uses that directory and
nothing else is set. Otherwise the cache lives at DEFAULT_DIR inside the
checkout (listed in .gitignore), so a run reads and writes nothing
outside its checkout.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> Path:
    """Point JAX's persistent compile cache at its directory; returns it."""
    if os.environ.get(ENV_VAR):
        return Path(os.environ[ENV_VAR])
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return DEFAULT_DIR
