"""Persistent XLA compilation cache for pvot entry points.

Compiling the chunked tracking scan takes seconds per geometry; JAX's
persistent compilation cache lets a second process reuse the executable.

Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and this module
sets no directory.  Otherwise the cache lives at one fixed path inside the
checkout (CACHE_DIR, listed in .gitignore): the path is part of the cache
key, so a directory that moved between runs would never hit.

The CLIs, bench.py and chip_smoke.py enable the cache; library users call
enable_compilation_cache() themselves, before the first compile.
"""

from __future__ import annotations

import os
import threading

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)

_cache_write_lock = threading.Lock()
_write_lock_installed = False


def _serialize_cache_writes() -> None:
    """Serialize persistent-cache writes across host threads.

    pvot compiles from worker threads (geometry groups in
    pvot.io.serving.serve_streams_grouped; devices= fan-out), and a
    cold-cache test run segfaulted inside
    jax._src.compilation_cache.put_executable_and_time ->
    executable.serialize() while a grouped-serving compile wrote its cache
    entry from a ThreadPoolExecutor worker.  Cache writes are rare (first
    compile of a program only), so a process-wide lock around the write
    path costs nothing at steady state.  Best-effort: if the internal module
    moves, skip — the cache still works, only the write path is unguarded
    again.
    """
    global _write_lock_installed
    if _write_lock_installed:
        return
    try:
        from jax._src import compilation_cache as cc

        inner = cc.put_executable_and_time

        def locked_put(*args, **kwargs):
            with _cache_write_lock:
                return inner(*args, **kwargs)

        cc.put_executable_and_time = locked_put
        _write_lock_installed = True
    except (ImportError, AttributeError):
        pass


def enable_compilation_cache() -> str:
    """Enable JAX's persistent compilation cache (idempotent) and return
    its directory: JAX_COMPILATION_CACHE_DIR if set, else CACHE_DIR."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        cache_dir = env
    else:
        cache_dir = CACHE_DIR
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    _serialize_cache_writes()
    return cache_dir
