"""JAX's persistent compilation cache, in one place for every entry point
(the CLI, bench.py, chip_smoke.py): repeat runs of a scene skip the
compile.

The directory is, in order: an explicit path (``--compilation-cache``);
``JAX_COMPILATION_CACHE_DIR``, which JAX reads itself and which is then
left alone; ``<checkout>/.jax_cache``, a fixed path derived from the
package's location (the path is part of the cache key, so it must not
move between runs).
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def cache_dir(explicit: str | os.PathLike | None = None,
              environ=os.environ) -> str:
    """The directory the cache uses, without touching JAX."""
    if explicit:
        return str(explicit)
    return environ.get(ENV_VAR) or str(DEFAULT_DIR)


def enable(explicit: str | os.PathLike | None = None) -> str:
    """Turn the cache on for this process and return its directory. Must
    run before the first compilation to take effect."""
    import jax

    path = cache_dir(explicit)
    if explicit or not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    # Persist every program: the solver compiles a handful of large
    # programs per scene, never many small ones.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
