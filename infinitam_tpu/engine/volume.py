"""World-model state: dense voxel array volume (+ accessors).

Re-design of the reference's scene objects
(reference: ITMLib/Objects/ITMScene.h:20, ITMPlainVoxelArray.h:21,
ITMLibDefines.h voxel structs): instead of an array-of-structs of voxels, the
volume is a struct-of-arrays pytree of jnp arrays — SDF and weight planes —
so XLA can lay each field out densely and fuse elementwise updates.

SDF is stored as float32 in [-1, 1] (the reference's short-quantized
`ITMVoxel_s` divides by 32767 on read; float storage is the reference's
`ITMVoxel_f` variant, ITMLibDefines.h:100-139). Weights are int32.

The voxel-block-hash volume lives in `hash_volume.py`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax.numpy as jnp

from infinitam_tpu.config import PlainVoxelArrayParams, SceneParams


class DenseVolume(NamedTuple):
    """Plain dense TSDF volume (reference: ITMPlainVoxelArray).

    Arrays are indexed [z, y, x] (z-major like the reference's linear index
    x + y*sx + z*sx*sy — we keep x fastest-moving as the last axis so layout
    matches).
    """

    sdf: jnp.ndarray  # [Z, Y, X] float32, init 1.0
    w_depth: jnp.ndarray  # [Z, Y, X] int32, init 0
    clr: Optional[jnp.ndarray] = None  # [Z, Y, X, 3] float32 0..1
    w_color: Optional[jnp.ndarray] = None  # [Z, Y, X] int32

    @property
    def size_xyz(self) -> Tuple[int, int, int]:
        Z, Y, X = self.sdf.shape
        return (X, Y, Z)


def create_dense(params: PlainVoxelArrayParams, with_color: bool = False) -> DenseVolume:
    """Allocate + reset (reference: ITMSceneReconstructionEngine::ResetScene —
    sdf=1.0, w=0)."""
    X, Y, Z = params.size
    sdf = jnp.ones((Z, Y, X), dtype=jnp.float32)
    w = jnp.zeros((Z, Y, X), dtype=jnp.int32)
    if with_color:
        clr = jnp.zeros((Z, Y, X, 3), dtype=jnp.float32)
        wc = jnp.zeros((Z, Y, X), dtype=jnp.int32)
        return DenseVolume(sdf=sdf, w_depth=w, clr=clr, w_color=wc)
    return DenseVolume(sdf=sdf, w_depth=w)


def reset_dense(vol: DenseVolume) -> DenseVolume:
    return DenseVolume(
        sdf=jnp.ones_like(vol.sdf),
        w_depth=jnp.zeros_like(vol.w_depth),
        clr=None if vol.clr is None else jnp.zeros_like(vol.clr),
        w_color=None if vol.w_color is None else jnp.zeros_like(vol.w_color),
    )


def voxel_world_coords(params: PlainVoxelArrayParams, voxel_size: float):
    """World-space (metres) coordinates of all voxel centers, [Z, Y, X, 3].

    Reference: ITMSceneReconstructionEngine_CPU plain-array IntegrateIntoScene
    iterates linear ids and converts via the array offset.
    """
    X, Y, Z = params.size
    ox, oy, oz = params.offset
    xs = (jnp.arange(X, dtype=jnp.float32) + ox) * voxel_size
    ys = (jnp.arange(Y, dtype=jnp.float32) + oy) * voxel_size
    zs = (jnp.arange(Z, dtype=jnp.float32) + oz) * voxel_size
    gz, gy, gx = jnp.meshgrid(zs, ys, xs, indexing="ij")
    return jnp.stack([gx, gy, gz], axis=-1)


def dense_read_sdf(
    vol: DenseVolume, params: PlainVoxelArrayParams, pts: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Uninterpolated SDF read at integer voxel coords (global voxel units).

    pts: [..., 3] int32 (x, y, z). Returns (sdf float32, found bool); out of
    bounds → (1.0, False) (reference: findVoxel plain-array overload,
    ITMRepresentationAccess.h:63-80, empty voxel sdf=1.0).
    """
    X, Y, Z = params.size
    off = jnp.array(params.offset, dtype=pts.dtype)
    p = pts - off
    inb = (
        (p[..., 0] >= 0)
        & (p[..., 0] < X)
        & (p[..., 1] >= 0)
        & (p[..., 1] < Y)
        & (p[..., 2] >= 0)
        & (p[..., 2] < Z)
    )
    pc = jnp.clip(p, 0, jnp.array([X - 1, Y - 1, Z - 1], dtype=p.dtype))
    v = vol.sdf[pc[..., 2], pc[..., 1], pc[..., 0]]
    return jnp.where(inb, v, 1.0), inb


def dense_read_sdf_and_weight(
    vol: DenseVolume, params: PlainVoxelArrayParams, pts: jnp.ndarray
):
    X, Y, Z = params.size
    off = jnp.array(params.offset, dtype=pts.dtype)
    p = pts - off
    inb = (
        (p[..., 0] >= 0)
        & (p[..., 0] < X)
        & (p[..., 1] >= 0)
        & (p[..., 1] < Y)
        & (p[..., 2] >= 0)
        & (p[..., 2] < Z)
    )
    pc = jnp.clip(p, 0, jnp.array([X - 1, Y - 1, Z - 1], dtype=p.dtype))
    v = vol.sdf[pc[..., 2], pc[..., 1], pc[..., 0]]
    w = vol.w_depth[pc[..., 2], pc[..., 1], pc[..., 0]]
    return jnp.where(inb, v, 1.0), jnp.where(inb, w, 0), inb


def make_dense_reader(vol: DenseVolume, params: PlainVoxelArrayParams):
    """An `(int_pts)->(sdf, found)` closure for the generic access combinators
    in ops/voxel_access.py."""

    def read(pts_int: jnp.ndarray):
        return dense_read_sdf(vol, params, pts_int)

    return read


def make_dense_color_reader(vol: DenseVolume, params: PlainVoxelArrayParams):
    """`(int_pts)->rgb [...,3]` closure; zeros when colorless/out of bounds."""
    X, Y, Z = params.size

    def read(pts_int: jnp.ndarray):
        if vol.clr is None:
            return jnp.zeros(pts_int.shape[:-1] + (3,), dtype=jnp.float32)
        off = jnp.array(params.offset, dtype=pts_int.dtype)
        p = pts_int - off
        inb = (
            (p[..., 0] >= 0)
            & (p[..., 0] < X)
            & (p[..., 1] >= 0)
            & (p[..., 1] < Y)
            & (p[..., 2] >= 0)
            & (p[..., 2] < Z)
        )
        pc = jnp.clip(p, 0, jnp.array([X - 1, Y - 1, Z - 1], dtype=p.dtype))
        c = vol.clr[pc[..., 2], pc[..., 1], pc[..., 0]]
        return jnp.where(inb[..., None], c, 0.0)

    return read
