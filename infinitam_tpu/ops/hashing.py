"""Spatial-hash primitives for the voxel-block-hash world model.

Reference parity: DeviceAgnostic/ITMRepresentationAccess.h:8-20 (hashIndex,
pointToVoxelBlockPos) and the allocation-planning ray march of
DeviceAgnostic/ITMSceneReconstructionEngine.h:141-241
(buildHashAllocAndVisibleTypePP).

All functions are vectorized over arbitrary leading dims and jit-safe.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

import jax.numpy as jnp
from infinitam_tpu.utils import se3

# reference hash constants (ITMRepresentationAccess.h:9).
# NOTE: numpy scalars, NOT jnp arrays — module-level jnp constants created at
# import time poison later XLA compiles in this environment (first jit after
# tracing one jumped from <1 s to minutes).
_P1 = np.uint32(73856093)
_P2 = np.uint32(19349669)
_P3 = np.uint32(83492791)


def hash_index(block_pos: jnp.ndarray, mask: int) -> jnp.ndarray:
    """((73856093·x) ^ (19349669·y) ^ (83492791·z)) & mask.  block_pos:
    [..., 3] int32 → [...] int32 in [0, mask]."""
    x = block_pos[..., 0].astype(jnp.uint32)
    y = block_pos[..., 1].astype(jnp.uint32)
    z = block_pos[..., 2].astype(jnp.uint32)
    h = (x * _P1) ^ (y * _P2) ^ (z * _P3)
    return (h & np.uint32(mask)).astype(jnp.int32)


def compact_by_mask(
    mask: jnp.ndarray,  # [N] bool
    values: jnp.ndarray,  # [N]
    size: int,
    fill,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Stream compaction: the first `size` True positions' values, in order
    (the analogue of the reference's prefix-sum compaction kernels,
    CUDA/ITMCUDAUtils.h:35-73). Cumsum + one masked scatter.

    Returns ([size] compacted values padded with `fill`, total True count —
    the count may exceed `size`; the overflow is dropped)."""
    pos = jnp.cumsum(mask.astype(jnp.int32)) - 1
    out = jnp.full((size,), fill, dtype=values.dtype).at[
        jnp.where(mask & (pos < size), pos, size)
    ].set(values, mode="drop")
    return out, jnp.sum(mask).astype(jnp.int32)


def point_to_block(point: jnp.ndarray, block_size: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Global voxel coords → (block coords, linear in-block index).

    Reference: pointToVoxelBlockPos — floor division toward −∞ for negatives.
    point: [..., 3] int32.
    """
    block = jnp.floor_divide(point, block_size)
    local = point - block * block_size
    linear = (
        local[..., 0]
        + local[..., 1] * block_size
        + local[..., 2] * block_size * block_size
    )
    return block, linear


def blocks_on_ray_segment_planes(
    depth: jnp.ndarray,  # [H, W] metric depth, −1 invalid
    proj: jnp.ndarray,  # (fx, fy, cx, cy)
    inv_M: jnp.ndarray,  # [4,4] camera→world
    mu: float,
    voxel_size: float,
    block_size: int,
    max_steps: int,
    view_frustum_min: float,
    view_frustum_max: float,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Candidate blocks touched by each pixel's ±mu ray-band segment, as
    COMPONENT PLANES — a variant of blocks_on_ray_segment that keeps every
    quantity as a flat [N] plane (N = H·W) stacked per DDA step.

    Returns (bx, by, bz, valid), each [max_steps, N] (int32 / bool)."""
    H, W = depth.shape
    N = H * W
    fx, fy, cx, cy = proj[0], proj[1], proj[2], proj[3]
    one_over_block = 1.0 / (voxel_size * block_size)

    d2 = depth.reshape(-1)
    valid_px = (d2 > 0.0) & (d2 - mu >= view_frustum_min) & (d2 + mu <= view_frustum_max)
    d = jnp.where(valid_px, d2, 1.0)

    xs = jnp.tile(jnp.arange(W, dtype=jnp.float32), H)
    ys = jnp.repeat(jnp.arange(H, dtype=jnp.float32), W)
    dcx = (xs - cx) / fx
    dcy = (ys - cy) / fy
    pcx = dcx * d
    pcy = dcy * d
    pcz = d
    norm = jnp.sqrt(pcx * pcx + pcy * pcy + pcz * pcz)
    sca_s = 1.0 - mu / norm
    sca_e = 1.0 + mu / norm

    R = inv_M[:3, :3]
    t = inv_M[:3, 3]

    def to_blocks(sca):
        px = pcx * sca
        py = pcy * sca
        pz = pcz * sca
        wx = (R[0, 0] * px + R[0, 1] * py + R[0, 2] * pz + t[0]) * one_over_block
        wy = (R[1, 0] * px + R[1, 1] * py + R[1, 2] * pz + t[1]) * one_over_block
        wz = (R[2, 0] * px + R[2, 1] * py + R[2, 2] * pz + t[2]) * one_over_block
        return wx, wy, wz

    bsx, bsy, bsz = to_blocks(sca_s)
    bex, bey, bez = to_blocks(sca_e)
    segx = bex - bsx
    segy = bey - bsy
    segz = bez - bsz

    # Exact 3-D DDA over the segment (see blocks_on_ray_segment docstring).
    def axis_t(blk, seg, bs):
        safe = jnp.where(jnp.abs(seg) < 1e-9, 1e-9, seg)
        nxt = blk + (seg > 0).astype(jnp.int32)
        ta = (nxt.astype(jnp.float32) - bs) / safe
        return jnp.where(jnp.abs(seg) < 1e-9, 2.0, ta)

    bx = jnp.floor(bsx).astype(jnp.int32)
    by = jnp.floor(bsy).astype(jnp.int32)
    bz = jnp.floor(bsz).astype(jnp.int32)
    tpar = jnp.zeros((N,), jnp.float32)
    out_x, out_y, out_z, out_v = [], [], [], []
    sgx = jnp.sign(segx).astype(jnp.int32)
    sgy = jnp.sign(segy).astype(jnp.int32)
    sgz = jnp.sign(segz).astype(jnp.int32)
    for _ in range(max_steps):
        out_x.append(bx)
        out_y.append(by)
        out_z.append(bz)
        out_v.append(valid_px & (tpar <= 1.0))
        tx = axis_t(bx, segx, bsx)
        ty = axis_t(by, segy, bsy)
        tz = axis_t(bz, segz, bsz)
        tx = jnp.where(tx <= tpar + 1e-7, 2.0, tx)
        ty = jnp.where(ty <= tpar + 1e-7, 2.0, ty)
        tz = jnp.where(tz <= tpar + 1e-7, 2.0, tz)
        t_next = jnp.minimum(jnp.minimum(tx, ty), tz)
        bx = bx + jnp.where(tx <= t_next + 1e-9, sgx, 0)
        by = by + jnp.where(ty <= t_next + 1e-9, sgy, 0)
        bz = bz + jnp.where(tz <= t_next + 1e-9, sgz, 0)
        tpar = t_next
    return (
        jnp.stack(out_x), jnp.stack(out_y), jnp.stack(out_z), jnp.stack(out_v)
    )


def blocks_on_ray_segment(
    depth: jnp.ndarray,  # [H, W] metric depth, −1 invalid
    proj: jnp.ndarray,  # (fx, fy, cx, cy)
    inv_M: jnp.ndarray,  # [4,4] camera→world
    mu: float,
    voxel_size: float,
    block_size: int,
    max_steps: int,
    view_frustum_min: float,
    view_frustum_max: float,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Candidate block coords touched by each pixel's ±mu ray-band segment.

    Reference: buildHashAllocAndVisibleTypePP — offsets the camera-frame
    surface point by ±mu ALONG THE RAY (scale 1 ∓ mu/|p|), converts both ends
    to block units, then marches in half-block steps (noSteps = ceil(2·len),
    endpoints inclusive). We emit a FIXED number of steps per pixel
    (max_steps) with a validity mask — static shapes for XLA.

    Returns (blocks [H, W, max_steps, 3] int32, valid [H, W, max_steps] bool).
    """
    H, W = depth.shape
    fx, fy, cx, cy = proj[0], proj[1], proj[2], proj[3]
    one_over_block = 1.0 / (voxel_size * block_size)

    # reference gate: skip if d−mu < frustum_min or d+mu > frustum_max
    valid_px = (depth > 0.0) & (depth - mu >= view_frustum_min) & (depth + mu <= view_frustum_max)
    d = jnp.where(valid_px, depth, 1.0)

    xs = jnp.arange(W, dtype=jnp.float32)[None, :].repeat(H, axis=0)
    ys = jnp.arange(H, dtype=jnp.float32)[:, None].repeat(W, axis=1)
    dir_cam = jnp.stack([(xs - cx) / fx, (ys - cy) / fy, jnp.ones_like(xs)], axis=-1)
    pt_cam = dir_cam * d[..., None]
    norm = jnp.linalg.norm(pt_cam, axis=-1)

    pt_s_cam = pt_cam * (1.0 - mu / norm)[..., None]
    pt_e_cam = pt_cam * (1.0 + mu / norm)[..., None]

    def to_blocks(pc):
        pw = se3.apply(inv_M, pc)
        return pw * one_over_block

    bs = to_blocks(pt_s_cam)
    be = to_blocks(pt_e_cam)
    seg = be - bs

    # Exact 3-D DDA over the segment: enumerate EVERY block the band crosses.
    # The reference point-samples at half-block steps
    # (ITMSceneReconstructionEngine.h:185-241, noSteps = ceil(2·len)), which
    # misses corner-crossing blocks and leaves first-frame pinholes; DDA at
    # the same static step budget is complete.
    safe_seg = jnp.where(jnp.abs(seg) < 1e-9, 1e-9, seg)
    blk = jnp.floor(bs).astype(jnp.int32)  # [H, W, 3]
    t = jnp.zeros_like(depth)
    blocks_list = []
    valid_list = []
    for _ in range(max_steps):
        blocks_list.append(blk)
        valid_list.append(valid_px & (t <= 1.0))
        # param t of the next boundary crossing per axis
        nxt = blk + (seg > 0).astype(jnp.int32)  # boundary coords
        t_axis = (nxt.astype(jnp.float32) - bs) / safe_seg
        t_axis = jnp.where(jnp.abs(seg) < 1e-9, 2.0, t_axis)
        t_axis = jnp.where(t_axis <= t[..., None] + 1e-7, 2.0, t_axis)  # crossed already
        t_next = jnp.min(t_axis, axis=-1)
        step_axis = t_axis <= t_next[..., None] + 1e-9
        blk = blk + jnp.where(step_axis, jnp.sign(seg).astype(jnp.int32), 0)
        t = t_next
    blocks = jnp.stack(blocks_list, axis=2)  # [H, W, max_steps, 3]
    valid = jnp.stack(valid_list, axis=2)
    return blocks, valid
