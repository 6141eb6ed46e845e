"""JAX backend selection and the persistent compilation cache.

The backend is whatever JAX initialises, or the platform that
``-platform`` names. Nothing here probes the device or falls back to
another platform: a run that asked for an accelerator and cannot reach
it fails.

Compiled programs are kept by JAX's own persistent compilation cache,
in ``$JAX_COMPILATION_CACHE_DIR`` when that is set and otherwise in
``<checkout>/.jax_cache``. The path is fixed so that a later run finds
what an earlier one compiled.
"""
from __future__ import annotations

import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(REPO, ".jax_cache")


def compile_cache_dir() -> str:
    """The directory JAX's persistent compilation cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX reads the variable
    itself and no other directory is set here. Call this before the
    first compile: JAX decides once per process whether the cache is
    used."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return compile_cache_dir()


def select_platform(platform: str = "") -> str:
    """Pin JAX to `platform` when one is named and return the platform
    of the default device. An unknown or unavailable platform raises."""
    import jax

    if platform:
        jax.config.update("jax_platforms", platform)
        return jax.devices(platform)[0].platform
    return jax.devices()[0].platform


def device_description() -> str:
    """`platform:device_kind xN` of the default backend."""
    import jax

    devs = jax.devices()
    return f"{devs[0].platform}:{devs[0].device_kind} x{len(devs)}"
