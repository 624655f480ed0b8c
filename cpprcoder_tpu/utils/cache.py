"""Persistent XLA compilation cache setup (compile once per shape, ever).

Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and this module
sets no directory. Otherwise the cache lives at the fixed <checkout>/.jax_cache
(the path is part of the cache key, so it must not move), and CPU runs get a
HOST-KEYED subdirectory: XLA:CPU cache entries are AOT machine code
specialized to the compiling host's CPU features, and loading an entry
produced on a different machine type can crash (the loader only warns)."""

from __future__ import annotations

import hashlib
import os
import platform

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".jax_cache"))

_DONE = False


def _host_tag() -> str:
    feats = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    feats = " ".join(sorted(line.split(":", 1)[1].split()))
                    break
    except OSError:
        pass
    h = hashlib.sha1((platform.machine() + feats).encode()).hexdigest()[:10]
    return f"cpu-{h}"


def cache_dir(platforms: str, environ=None) -> str | None:
    """The directory to set for a run on `platforms` (JAX's platform
    setting), or None where the environment already names one."""
    environ = os.environ if environ is None else environ
    if environ.get(ENV_VAR):
        return None
    if "cpu" in platforms:
        return os.path.join(DEFAULT_DIR, _host_tag())
    return DEFAULT_DIR


def enable_compilation_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    global _DONE
    import jax

    if not _DONE:
        _DONE = True
        path = cache_dir(jax.config.jax_platforms or "")
        if path is not None:
            os.makedirs(path, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
    return jax.config.jax_compilation_cache_dir
