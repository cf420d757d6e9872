"""Persistent XLA compilation cache.

A fresh process otherwise re-compiles the big epoch/eval programs it
compiled last run. JAX's persistent compilation cache keys executables by
HLO + compile options + backend version, so enabling it is safe across
code changes. The directory is part of the cache's key, so it must not
move between runs: it is either the one ``JAX_COMPILATION_CACHE_DIR``
names (JAX reads that variable itself; nothing is set in code then) or
one fixed, git-ignored directory inside the checkout.

``enable_compilation_cache`` is called by the CLI (heat_cf.main), the
benchmarks, and the dryrun entry; library users opt in explicitly.
``HEAT_CF_NO_COMPILATION_CACHE=1`` disables it.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compilation_cache() -> str | None:
    """Turn on JAX's persistent compilation cache.

    Returns the directory in effect: ``$JAX_COMPILATION_CACHE_DIR`` when
    set, a directory already set through ``jax.config``, else
    ``DEFAULT_DIR`` (``<checkout>/.jax_cache``). None when disabled.
    """
    import jax

    if os.environ.get("HEAT_CF_NO_COMPILATION_CACHE") == "1":
        return None
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    current = jax.config.jax_compilation_cache_dir
    if current:
        return current
    os.makedirs(DEFAULT_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
