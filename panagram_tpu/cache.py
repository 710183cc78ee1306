"""Where the persistent XLA compile cache lives.

Compiles of the anchor and dictionary programs take seconds each on a
fresh process; JAX's persistent cache lets the next process load them
instead.  A cache is only found again at the same path, so the default
is a fixed directory of the checkout (listed in .gitignore)."""

from __future__ import annotations

import os

_ENV = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else <checkout>/.jax_cache."""
    env = os.environ.get(_ENV)
    if env:
        return env
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.join(os.path.dirname(here), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at compile_cache_dir() and
    return the path.  When the environment variable is set, JAX already
    reads it, and nothing else is set."""
    path = compile_cache_dir()
    if not os.environ.get(_ENV):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
