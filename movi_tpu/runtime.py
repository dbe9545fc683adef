"""Process-level JAX set-up shared by the CLI, the benchmark, the smoke
run and the tests: the persistent compile cache, the platform choice,
and what the process runs on.

Each is applied once, before the first JAX computation, and fails loudly:
a run that asked for a GPU never carries on on the CPU.
"""

from __future__ import annotations

import os
import subprocess

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_DIR = os.path.join(REPO_ROOT, ".xla_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and
    nothing is set here.  Otherwise the cache is the fixed `.xla_cache/`
    at the checkout root: the directory is part of the cache key, so it
    must not follow the index directory, a temporary name or the pid."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR


def apply_platform(platform: str):
    """Pin JAX to `platform` ("cpu" or "gpu") before any JAX use.

    Raises SystemExit when the backend cannot start or is not the one
    asked for; there is no fallback to another device."""
    import jax

    jax.config.update("jax_platforms",
                      "cuda" if platform == "gpu" else platform)
    try:
        got = jax.devices()[0].platform
    except (RuntimeError, AssertionError) as e:
        raise SystemExit(f"platform {platform!r} is not available: {e!r}")
    want = "gpu" if platform in ("gpu", "cuda") else platform
    if got != want:
        raise SystemExit(f"platform {platform!r} requested, JAX runs on "
                         f"{got!r}")


def require_gpu():
    """Exit non-zero unless JAX's default device is a GPU (device
    measurements are never taken on the CPU)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX found {dev.platform!r} "
                         f"({dev.device_kind})")


def card_name_and_power_limit() -> str:
    """Each card's name and power limit as nvidia-smi reports them (one
    line per card), read in a child process that does not import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def device_facts() -> dict:
    """platform, device_kind and device count as JAX reports them."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
