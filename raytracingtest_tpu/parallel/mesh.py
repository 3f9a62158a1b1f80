"""Device-mesh construction for ray sharding.

The reference's only parallelism is GPU thread-per-pixel within one chip
(SURVEY.md §2.8). Here the distribution axis is the ray/pixel batch — this
module builds the flat 1-D "rays" mesh used by shard_map (every card of a
host reaches every other over NVLink, so the mesh follows the algorithm
alone); octree arrays are replicated (level-sharded deep octrees are the
depth>=12 extension).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

RAY_AXIS = "rays"


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (RAY_AXIS,))


def ray_sharding(mesh: Mesh) -> NamedSharding:
    """Rays sharded on their leading (batch) axis."""
    return NamedSharding(mesh, P(RAY_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
