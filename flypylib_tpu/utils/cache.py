"""Persistent XLA compilation cache.

Fresh :class:`~flypylib_tpu.infer.large._StreamPlan`\\ s, tiled engines
and train steps each compile several executables.  JAX's persistent
compilation cache keeps them across PROCESSES: the serialized executable
is keyed on the HLO + compile options + runtime fingerprint and reloaded
instead of recompiled.  This matters wherever processes restart with the
same geometry: elastic streaming workers re-joining a shared ROI queue
(:mod:`flypylib_tpu.infer.elastic`), repeated CLI invocations over the
same volume shapes, and test runs.

Usage (before the first jit compilation):

    from flypylib_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()

Where the cache lives, in order:

1. ``$JAX_COMPILATION_CACHE_DIR`` when it is set — JAX reads it itself,
   and this helper then sets no other directory, whatever the caller
   passes;
2. else ``path`` when given;
3. else ``<checkout>/.jax_cache`` (:data:`DEFAULT_CACHE_DIR`), one fixed
   directory inside the repository, listed in ``.gitignore``.  A fixed
   path matters: the path is part of what JAX keys on, so a directory
   that moved between runs would never hit.
"""

from __future__ import annotations

import os

__all__ = ["enable_compilation_cache", "DEFAULT_CACHE_DIR"]

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__
    )))),
    ".jax_cache",
)


def enable_compilation_cache(
    path: str | None = None,
    min_compile_time_secs: float = 1.0,
) -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    See the module docstring for which directory is used.  Executables
    whose compile took less than ``min_compile_time_secs`` are not
    persisted (skip churn from trivial dispatches).

    Call it BEFORE the process's first jit compilation: jax
    initializes the persistent cache lazily on first use and ignores
    later directory updates within the same process.
    """
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        path = env
    else:
        path = path or DEFAULT_CACHE_DIR
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs",
        float(min_compile_time_secs),
    )
    return path
