"""Persistent XLA compilation cache location.

Every structural settings variant compiles its own executables, and a
cold process on the GPU would otherwise recompile all of them.  JAX
keeps compiled executables in the directory ``jax_compilation_cache_dir``
names; the directory is part of what makes an entry findable again, so
it must not move between runs.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

# <checkout>/.emspec/jax_cache — fixed, inside the checkout, and listed in
# .gitignore (the .emspec/ user directory)
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".emspec" / "jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at a fixed directory and
    return it.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is changed here.  Otherwise the cache goes to
    :data:`DEFAULT_DIR`.  Call before the process compiles anything: JAX
    decides whether to use a cache at its first compilation."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
