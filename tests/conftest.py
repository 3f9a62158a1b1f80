"""Test environment: the CPU backend with a virtual 8-device mesh.

Multi-device sharding tests run on simulated host devices
(SURVEY.md §4: XLA_FLAGS=--xla_force_host_platform_device_count). The GPU is
exercised by `python chip_smoke.py` on a machine with a card (markers:
pytest.ini).

The platform is pinned through jax.config as well as JAX_PLATFORMS, so a
site configuration that selects another backend at interpreter start-up
cannot move the tests off the CPU. The persistent compile cache is off:
test workers compile small programs and must not share a cache directory.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_compilation_cache", False)
assert jax.devices()[0].platform == "cpu"
assert jax.device_count() == 8

