"""Which backend runs, which DP kernel it gets, and the compile cache.

Every entry point (CLI, graphunzip, the distributed launcher, bench.py,
chip_smoke.py) calls `init_compile_cache` before its first compile, and
every device-vs-host decision goes through `platform`: a backend this
program was not written for is an error, never a silent fallback.
"""

from __future__ import annotations

import os

PLATFORMS = ("cpu", "gpu")

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CACHE_DIR = os.path.join(_REPO_ROOT, ".jax_cache")


def platform() -> str:
    """The platform of JAX's default device: 'cpu' or 'gpu'."""
    import jax

    p = jax.devices()[0].platform
    if p not in PLATFORMS:
        raise RuntimeError(f"unsupported JAX platform {p!r}; expected one of {PLATFORMS}")
    return p


def on_gpu() -> bool:
    return platform() == "gpu"


def dp_kernel(platform: str) -> str:
    """The banded-DP implementation for a platform:

    gpu -> 'jnp'    (the plain-JAX scan, compiled by XLA; any band);
    cpu -> 'native' (the threaded C++ DP + traceback)."""
    if platform == "gpu":
        return "jnp"
    if platform == "cpu":
        return "native"
    raise ValueError(f"no DP kernel for platform {platform!r}; expected one of {PLATFORMS}")


def device_summary() -> dict:
    """platform, device_kind and device count, as JAX reports them."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind, "count": len(devs)}


def init_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    When JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and no other
    directory is set here. Otherwise the cache lives at one fixed path in
    the checkout (`.jax_cache`, git-ignored): the path is part of the
    cache's key, so it never names a temp dir, pid or time."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
