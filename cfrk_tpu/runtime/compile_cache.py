"""Where JAX keeps its persistent compilation cache.

The cache's path is part of its key, so it must not move between runs:
``JAX_COMPILATION_CACHE_DIR`` when the environment sets it (JAX reads
the variable itself, and nothing is set here), else the fixed
``<checkout>/.jax_cache`` (listed in ``.gitignore``).
"""

from __future__ import annotations

import os

__all__ = ["CHECKOUT_CACHE_DIR", "setup_compile_cache"]

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def setup_compile_cache() -> str:
    """Point JAX at the compile cache; returns the directory in use.

    Call before the first compilation (the CLI, ``bench.py`` and
    ``chip_smoke.py`` do so first thing).
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    return CHECKOUT_CACHE_DIR
