"""Location of JAX's persistent compile cache.

JAX keys its persistent cache by directory, so the directory has to stay
put between runs.  When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX has
already read it and this module leaves the setting alone; otherwise the
cache lives in ``<checkout>/.jax_cache``, located from this file (the
directory is listed in ``.gitignore``).
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache for every compiled program;
    returns the directory in use."""
    path = os.environ.get(ENV_VAR)
    if not path:
        path = str(DEFAULT_DIR)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return path
