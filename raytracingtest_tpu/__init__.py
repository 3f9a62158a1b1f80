"""raytracingtest_tpu — a differentiable sparse-voxel-octree renderer in JAX.

A from-scratch JAX framework with the capabilities of the reference
Unity/C#/HLSL project `epitaque/RaytracingTest` (see SURVEY.md):

- SVO construction from implicit signed-density samplers
  (reference: Assets/Scripts/SVO/CompactSVO/NaiveCreator.cs)
- ESVO-style hierarchical ray traversal (Laine-Karras PUSH/ADVANCE/POP)
  (reference: Assets/Scripts/SVO/CompactSVO/Trace.cu,
   Assets/Shaders/NVIDIASVO.compute)
- A megakernel forward renderer with progressive accumulation
  (reference: Assets/Shaders/RaytraceCompute.compute,
   Assets/Scripts/SVO/GPU/RaytracingMaster.cs)
- Slice-based incremental construction + clipmap streaming
  (reference: Assets/Scripts/SliceBasedSVO/, Assets/Scripts/Clipmap/)
- New capabilities with no reference counterpart: differentiability
  (custom VJP to per-voxel parameters) and multi-device sharding via
  jax.sharding / shard_map.

Architecture: pointer-free breadth-first level arrays instead of pointer
trees, vectorized lane-parallel traversal instead of divergent threads,
functional pytrees instead of MonoBehaviours. It runs on one NVIDIA GPU or
several (python chip_smoke.py checks the main path on a card).
"""

__version__ = "0.1.0"

from raytracingtest_tpu.ops.octree import SVO, build_svo  # noqa: F401
from raytracingtest_tpu.scenes import SCENES, Scene, get_scene  # noqa: F401
