"""Multi-host scaffolding: jax.distributed init + process-local ray shards.

BASELINE config 5 runs on several hosts; this module is the entry layer
that makes every entry point (bench.py, cli.py fit) one flag away from that
topology while degrading to a no-op on a single host:

  * init_from_env() calls jax.distributed.initialize when the coordinator
    variables are present (JAX_COORDINATOR_ADDRESS, or RAYT_MULTIHOST=auto
    for a cluster jax.distributed can auto-detect) and is a no-op
    otherwise.
  * ProcessRays gives each process ONLY its slice of the global pixel grid
    (process-local ray generation — no host materializes the full image),
    plus the global<->local row bookkeeping for assembling outputs with
    jax.make_array_from_process_local_data.

The reference has no distribution at all (SURVEY.md §2.8); its analog of a
"transport" is ComputeBuffer.SetData (RaytracingMaster.cs:107-108). Here the
transport is XLA collectives (NCCL on GPUs) via the mesh in
parallel/mesh.py.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

import jax


def init_from_env(verbose: bool = True) -> dict:
    """Initialize jax.distributed from environment variables if present.

    Recognized: JAX_COORDINATOR_ADDRESS (host:port), JAX_NUM_PROCESSES,
    JAX_PROCESS_ID. On clusters it recognizes (e.g. SLURM),
    jax.distributed.initialize() can also auto-detect everything, which
    RAYT_MULTIHOST=auto requests explicitly.
    Single-host (nothing set): no-op. Returns a status dict."""
    mode = os.environ.get("RAYT_MULTIHOST", "")
    coord = os.environ.get("JAX_COORDINATOR_ADDRESS", "")
    if not coord and mode != "auto":
        return {
            "initialized": False,
            "process_index": 0,
            "process_count": 1,
            "reason": "single-host (no JAX_COORDINATOR_ADDRESS / "
                      "RAYT_MULTIHOST)",
        }
    kwargs = {}
    if coord:
        kwargs["coordinator_address"] = coord
        n = os.environ.get("JAX_NUM_PROCESSES")
        pid = os.environ.get("JAX_PROCESS_ID")
        if n is not None:
            kwargs["num_processes"] = int(n)
        if pid is not None:
            kwargs["process_id"] = int(pid)
    jax.distributed.initialize(**kwargs)
    info = {
        "initialized": True,
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": jax.device_count(),
    }
    if verbose and jax.process_index() == 0:
        print(f"# jax.distributed: {info}")
    return info


@dataclasses.dataclass(frozen=True)
class ProcessRays:
    """This process's slice of a global pixel-row range."""

    row_start: int
    row_stop: int
    height: int
    width: int

    @property
    def n_local(self) -> int:
        return (self.row_stop - self.row_start) * self.width


def process_rows(height: int, width: int,
                 process_index: int | None = None,
                 process_count: int | None = None) -> ProcessRays:
    """Partition image rows across processes (contiguous blocks; height must
    divide evenly — pad the image otherwise)."""
    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    if height % pc:
        raise ValueError(f"height {height} not divisible by {pc} processes")
    rows = height // pc
    return ProcessRays(row_start=pi * rows, row_stop=(pi + 1) * rows,
                       height=height, width=width)


def local_camera_rays(camera, pr: ProcessRays, xp=np, jitter=None):
    """Generate ONLY this process's rays (rows [row_start, row_stop) of the
    camera's pixel grid) — no host touches the full image."""
    o, d = camera.rays(xp, jitter=jitter)
    o = o.reshape(pr.height, pr.width, 3)[pr.row_start:pr.row_stop]
    d = d.reshape(pr.height, pr.width, 3)[pr.row_start:pr.row_stop]
    return o.reshape(-1, 3), d.reshape(-1, 3)


def global_ray_array(mesh, pr: ProcessRays, local_rows):
    """Assemble a global device array from per-process local ray rows
    (multi-host path of jax.make_array_from_process_local_data)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from raytracingtest_tpu.parallel.mesh import RAY_AXIS

    sharding = NamedSharding(mesh, P(RAY_AXIS, None))
    global_shape = (pr.height * pr.width,) + tuple(local_rows.shape[1:])
    if jax.process_count() == 1:
        return jax.device_put(local_rows, sharding)
    return jax.make_array_from_process_local_data(
        sharding, np.asarray(local_rows), global_shape)
