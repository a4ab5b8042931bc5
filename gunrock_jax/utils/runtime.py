"""Process set-up shared by the entry points (CLI, C API, bench scripts,
``chip_smoke.py``): the persistent compile cache and the device record
every measurement carries."""

from __future__ import annotations

import os
import subprocess
from typing import Optional

__all__ = ["CHECKOUT", "compile_cache_dir", "enable_compile_cache",
           "gpu_name_and_power_limit", "device_record"]

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``
    (a fixed path: the directory is part of the cache key)."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".jax_cache"))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache; returns its directory.
    When ``JAX_COMPILATION_CACHE_DIR`` is set JAX reads it itself and
    nothing is overridden here."""
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        import jax
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def gpu_name_and_power_limit() -> Optional[str]:
    """``name, power.limit`` of each card as ``nvidia-smi`` reports them
    (one line per card), or None where there is no ``nvidia-smi``. Runs
    as a child process that never touches JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def device_record() -> dict:
    """The device a measurement ran on, as JAX and ``nvidia-smi`` see it."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform,
            "device_kind": devs[0].device_kind,
            "device_count": len(devs),
            "gpu": gpu_name_and_power_limit()}
