"""JAX's persistent compilation cache, set up the same way by every entry
point (the CLI, ``bench.py``, ``chip_smoke.py`` and the benchmark scripts).

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing is
set here. Otherwise the cache lives at one fixed path inside the checkout,
``<repo>/.jax_cache`` (listed in ``.gitignore``): the path is part of the
cache key, so a directory that moves would never hit.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache(min_compile_time_s=0.5):
    """Point JAX's persistent cache at its directory and return that path.

    ``min_compile_time_s``: programs that compile faster than this are not
    written (0.5 s keeps the diagnostics program and the small kernels)."""
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", min_compile_time_s
    )
    return REPO_CACHE_DIR
