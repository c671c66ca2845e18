"""Persistent XLA compilation cache: the sweep program is large (scan over a
masked while-loop over the whole particle population) and cold compiles cost
minutes; caching makes repeat CLI/bench invocations start in seconds.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
directory is set here.  Otherwise the cache lives at the fixed absolute path
``<checkout>/.jax_cache``: the path is part of the cache key, so it must not
depend on the working directory."""

import os

CHECKOUT_CACHE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", ".jax_cache")
)


def enable_compilation_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = CHECKOUT_CACHE_DIR
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
