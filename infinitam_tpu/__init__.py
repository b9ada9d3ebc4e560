"""infinitam_tpu — a dense volumetric SLAM framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of InfiniTAM v2
(reference: ethz-asl/infinitam): per-frame depth→track→fuse→raycast on a TSDF
volume with dense-array and voxel-block-hash world representations, a
hierarchical Gauss-Newton point-to-plane ICP tracker family, expected-depth
accelerated raycasting, marching-cubes meshing, and host↔HBM voxel-block
streaming.

Design: batch-first functional pipeline. All state is pytrees of jnp arrays;
every per-frame stage is a pure jitted function; multi-sequence batches are
vmapped and sharded over a `jax.sharding.Mesh`.
"""

__version__ = "0.1.0"

from infinitam_tpu.config import SceneParams, Settings, TrackerType  # noqa: F401
