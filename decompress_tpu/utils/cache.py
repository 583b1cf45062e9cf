"""Persistent XLA compile cache for the framework's kernels.

The codec kernels have a handful of large compiled variants (per level
and segment size); caching them on disk makes every process after the
first start fast.  When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX keeps
the cache there and this module sets no other; otherwise the cache
lives in the checkout's ``.jax_cache/``.  Enabled automatically by
``decompress_tpu.ops`` unless ``DECOMPRESS_TPU_NO_CACHE`` is set.
"""

from __future__ import annotations

import os
import pathlib

_DONE = False
_CHECKOUT = pathlib.Path(__file__).resolve().parents[2]


def cache_dir() -> pathlib.Path:
    """Where compiled kernels are cached."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    return pathlib.Path(env) if env else _CHECKOUT / ".jax_cache"


def enable_compile_cache() -> None:
    global _DONE
    if _DONE or os.environ.get("DECOMPRESS_TPU_NO_CACHE"):
        return
    _DONE = True
    import jax

    # set from JAX_COMPILATION_CACHE_DIR, or by the caller (e.g. the
    # test conftest)
    if jax.config.jax_compilation_cache_dir:
        return
    path = cache_dir()
    path.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(path))
