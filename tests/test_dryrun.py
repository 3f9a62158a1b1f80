"""Multi-device dryrun in a clean interpreter.

A custom-VJP varying-manual-axes error once escaped every in-process test:
it fires only when JAX's backward-pass type checks are enabled
(jax_disable_bwd_checks=False, the default), and a site configuration that
changes that flag at interpreter start-up hid it from the in-process run.

This test runs `__graft_entry__.dryrun_multichip(8)` (the dispatch-boundary
analog of the reference's RaytracingMaster.cs:66-68) in a subprocess with
JAX's defaults: JAX_PLATFORMS=cpu, an 8-device forced host platform, and no
pytest conftest, so the bwd checks stay at their default ON.

The full dryrun includes a depth-12 2048^2 level-sharded render (~3-5 min
on host devices); RTT_DRYRUN_FAST=1 skips that scale section while keeping
every shard_mapped grad path (where the recorded failure mode lives).
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dryrun_multichip_driver_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    flags = env.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        env["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    # keep every shard_mapped fwd+bwd path but skip the depth-12 scale
    # section so the whole suite stays runnable
    env["RTT_DRYRUN_FAST"] = "1"
    proc = subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__ as g; g.dryrun_multichip(8)"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=1100)
    assert proc.returncode == 0, (
        f"clean-interpreter dryrun failed (rc={proc.returncode}):\n"
        f"--- stdout ---\n{proc.stdout[-4000:]}\n"
        f"--- stderr ---\n{proc.stderr[-4000:]}")
    assert "train step ok" in proc.stdout
