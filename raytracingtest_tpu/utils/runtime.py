"""Process set-up shared by the entry points (cli.main, bench.py,
chip_smoke.py): the persistent compile cache and a description of the
accelerator the process runs on."""

from __future__ import annotations

import os
import subprocess

# the checkout's root: raytracingtest_tpu/utils/runtime.py -> ../../
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# fixed path: JAX keys its cache entries by content, but a directory that
# moves between runs never hits, so no temporary name, pid or time here
DEFAULT_COMPILE_CACHE = os.path.join(REPO_ROOT, ".jax_cache")


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at a stable directory and
    return it. A JAX_COMPILATION_CACHE_DIR set in the environment wins and is
    left alone (JAX reads it itself); otherwise the cache lives in the
    checkout. Call before the first compile: JAX decides once per process
    whether the cache is in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_COMPILE_CACHE)
    return DEFAULT_COMPILE_CACHE


def device_info() -> dict:
    """The first device as JAX reports it, plus the device count."""
    import jax
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi`'s name and power limit of each card, one per line. A card
    may be capped below its rated power and then runs slower under load, so
    every timing is reported beside this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()
