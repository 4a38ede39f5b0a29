"""Placement of XLA's persistent compile cache.

The sweep compiles once per (word class, shape bucket); without a disk
cache every fresh process pays those compiles again.  One rule places the
cache for the CLI, bench.py, chip_smoke.py and tools/:

- a user's own JAX_COMPILATION_CACHE_DIR wins, and no other directory is
  set;
- otherwise the cache lives at a fixed path inside the checkout
  (DEFAULT_CACHE_DIR, listed in .gitignore).  The path is part of the
  cache's key, so it never depends on the working directory, a process
  id or the time.
"""

from __future__ import annotations

import os
import sys

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def compile_cache_dir() -> str:
    """The directory the persistent compile cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at compile_cache_dir().

    Sets the environment (read when jax is imported) and, when jax is
    already imported, its config too: jax snapshots these values at import
    time, and importing khoice_tpu pulls jax in before a CLI main() runs,
    so the environment alone would be silently ignored.  Returns the
    directory."""
    cache = compile_cache_dir()
    os.environ["JAX_COMPILATION_CACHE_DIR"] = cache
    os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.5")
    os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "-1")
    if "jax" in sys.modules:
        import jax

        jax.config.update("jax_compilation_cache_dir", cache)
        jax.config.update(
            "jax_persistent_cache_min_compile_time_secs",
            float(os.environ["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"]),
        )
        jax.config.update(
            "jax_persistent_cache_min_entry_size_bytes",
            int(os.environ["JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES"]),
        )
    return cache
