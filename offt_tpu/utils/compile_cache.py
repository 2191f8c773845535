"""JAX's persistent compilation cache at one fixed place.

Every entry point (``chip_smoke.py``, ``bench.py``, ``offt-bench``,
``offt-tune``, ``offt-baseline``) calls :func:`enable_compile_cache`
before it compiles anything. The cache key includes the directory, so the
directory never comes from a temporary name, a pid or the time.
"""

from __future__ import annotations

import os
import pathlib

ENV = "JAX_COMPILATION_CACHE_DIR"
# <checkout>/.jax_cache (listed in .gitignore)
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Use ``$JAX_COMPILATION_CACHE_DIR`` where it is set (JAX reads the
    variable itself, so nothing is set here); otherwise point JAX at
    ``<checkout>/.jax_cache``. Returns the directory in use. Touches no
    device, so a parent process that only spawns trials stays off the
    card."""
    env = os.environ.get(ENV)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
