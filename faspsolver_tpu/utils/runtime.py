"""Run-time environment of the measurement scripts (bench.py, chip_smoke.py,
tools/spmv_explore.py): the compile cache's directory, the device check and
the card's identity.

The persistent compilation cache lives where ``JAX_COMPILATION_CACHE_DIR``
says when it is set, and otherwise at ``<repo>/.jax_cache`` (gitignored).
The path is part of the cache key, so a fixed path is what lets one run
find what the last one compiled.  Nothing else sets a cache directory.
"""
from __future__ import annotations

import os
import subprocess

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_REPO_ROOT, ".jax_cache"))


def enable_compile_cache(min_compile_secs: float = 0.1) -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir` and
    keep every program that took at least ``min_compile_secs`` to compile.
    Returns the directory."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_secs))
    return path


def require_gpu(count: int = 1):
    """Print the device JAX runs on; raise unless it is a GPU and at least
    ``count`` of them are visible.  Measurements never fall back to the
    CPU.  Returns ``jax.devices()``."""
    import jax

    devs = jax.devices()
    d = devs[0]
    print(f"device: platform={d.platform} kind={d.device_kind} "
          f"count={len(devs)}", flush=True)
    if d.platform != "gpu":
        raise RuntimeError(f"needs a GPU; JAX's default backend is "
                           f"{d.platform}")
    if len(devs) < count:
        raise RuntimeError(f"needs {count} GPUs; {len(devs)} visible")
    return devs


def card_info() -> str:
    """Each card's name and power limit as nvidia-smi reports them, one
    line per card (run in a child process that does not import JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()
