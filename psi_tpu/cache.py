"""Persistent XLA compile cache.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and this
module sets no other directory. Otherwise the cache lives at one fixed
path inside the checkout, `.jax_cache/` (listed in .gitignore): the
directory is part of the cache key, so a path that moved between runs
would never hit.

XLA CPU executables embed the build host's CPU feature set, and loading
one compiled on another machine can crash, so CPU entries go to a
subdirectory keyed by the host fingerprint. GPU executables are keyed
by JAX on the device itself.

Entry points (`psikt`, bench.py, chip_smoke.py, scripts/) call
`enable_compile_cache()` once, before their first compile.
"""

from __future__ import annotations

import hashlib
import os

ENV = "JAX_COMPILATION_CACHE_DIR"
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_DIR = os.path.join(_REPO, ".jax_cache")


def host_fingerprint() -> str:
    """Short stable hash of what determines CPU-executable
    compatibility: machine arch + the CPU flag set + model name."""
    import platform

    parts = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith(("flags", "model name")):
                    parts.append(line.strip())
                    if len(parts) >= 3:
                        break
    except OSError:
        pass
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:12]


def compile_cache_dir(backend: str, create: bool = True) -> str:
    """Cache directory for `backend` ("gpu" | "cpu"): the environment
    variable's value when set, else the fixed in-checkout path (with a
    per-host subdirectory for CPU executables)."""
    d = os.environ.get(ENV)
    if not d:
        d = DEFAULT_DIR
        if backend == "cpu":
            d = os.path.join(d, f"cpu-{host_fingerprint()}")
    if create:
        os.makedirs(d, exist_ok=True)
    return d


def enable_compile_cache(jax_module=None) -> str:
    """Point JAX at the persistent cache for the active platform;
    returns the directory. With the environment variable set, JAX
    already uses it and nothing is overridden."""
    if jax_module is None:
        import jax as jax_module
    from psi_tpu import platform

    d = compile_cache_dir(platform.active().platform)
    if not os.environ.get(ENV):
        jax_module.config.update("jax_compilation_cache_dir", d)
    jax_module.config.update(
        "jax_persistent_cache_min_compile_time_secs", 1.0
    )
    return d
