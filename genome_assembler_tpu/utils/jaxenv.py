"""JAX runtime setup: the persistent compile cache and multi-process wiring.

The program runs on whatever platform ``JAX_PLATFORMS`` selects (JAX's
own default when unset) and never switches platform on its own.

Call ``setup()`` once before the first device use.
"""

from __future__ import annotations

import os

_DONE = False

# <checkout>/.jax_cache: fixed, so the cache's key (its path) is stable
# across processes and runs of one checkout.
DEFAULT_CACHE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".jax_cache")
)


def cache_dir() -> str:
    """Where compiled programs persist: ``JAX_COMPILATION_CACHE_DIR`` when
    set (JAX reads it itself), else the fixed in-checkout directory."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def setup() -> None:
    global _DONE
    import jax

    if not _DONE:
        if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
        _DONE = True

    # Multi-process launches must initialize jax.distributed before ANY
    # backend touch (jax.devices/device_put). Idempotent; no-op unless
    # GA_DIST=1.
    from ..parallel.mesh import init_distributed

    init_distributed()


def to_host(x):
    """Fetch a jax array to host numpy, multi-process safe.

    Single-process: a plain np.asarray. Multi-process: arrays sharded
    across processes are not fully addressable, so np.asarray raises —
    process_allgather assembles the global value on every host instead.
    """
    import numpy as np

    if getattr(x, "is_fully_addressable", True):
        return np.asarray(x)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))
