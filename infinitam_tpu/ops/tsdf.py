"""TSDF fusion core — depth and color running-average voxel updates.

Representation-agnostic and fully vectorized: callers pass voxel center world
positions of any shape [..., 3] plus the matching old (sdf, w) arrays; the
dense pipeline passes the whole grid, the hash pipeline passes gathered
visible blocks.

Reference parity: DeviceAgnostic/ITMSceneReconstructionEngine.h:10-139
(computeUpdatedVoxelDepthInfo, computeUpdatedVoxelColorInfo,
ComputeUpdatedVoxelInfo<hasColor>).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax.numpy as jnp

from infinitam_tpu.ops.pixel import bilinear
from infinitam_tpu.utils import se3


class TsdfUpdate(NamedTuple):
    sdf: jnp.ndarray
    w_depth: jnp.ndarray
    eta: jnp.ndarray  # signed surface distance (depth − z_cam); −1 marks "no ray"
    updated: jnp.ndarray  # bool: voxel actually touched


def update_voxel_depth(
    old_sdf: jnp.ndarray,
    old_w: jnp.ndarray,
    pt_world: jnp.ndarray,  # [..., 3] metres
    M_d: jnp.ndarray,  # [4,4] world→depth-camera
    proj_d: jnp.ndarray,  # (fx, fy, cx, cy)
    depth: jnp.ndarray,  # [H, W] metric depth, −1 invalid
    mu: float,
    max_w: int,
) -> TsdfUpdate:
    """Project voxel center into the depth image and fold the new observation
    into the running average (reference: computeUpdatedVoxelDepthInfo).

    newF = min(1, eta/mu) averaged with weight 1 against (oldF, oldW),
    weight capped at max_w; voxels behind the surface by more than mu
    (eta < −mu) are untouched.
    """
    H, W = depth.shape
    fx, fy, cx, cy = proj_d[0], proj_d[1], proj_d[2], proj_d[3]

    pc = se3.apply(M_d, pt_world)
    z = pc[..., 2]
    valid = z > 0

    u = fx * pc[..., 0] / jnp.where(valid, z, 1.0) + cx
    v = fy * pc[..., 1] / jnp.where(valid, z, 1.0) + cy
    # reference bounds: 1 <= u <= W-2 (leaves a 1px margin)
    valid &= (u >= 1) & (u <= W - 2) & (v >= 1) & (v <= H - 2)

    ui = (u + 0.5).astype(jnp.int32)
    vi = (v + 0.5).astype(jnp.int32)
    ui = jnp.clip(ui, 0, W - 1)
    vi = jnp.clip(vi, 0, H - 1)
    depth_measure = depth[vi, ui]
    valid &= depth_measure > 0.0

    eta = depth_measure - z
    do_update = valid & (eta >= -mu)

    new_f = jnp.minimum(1.0, eta / mu)
    merged_f = (old_w * old_sdf + new_f) / (old_w + 1)
    merged_w = jnp.minimum(old_w + 1, max_w)

    out_sdf = jnp.where(do_update, merged_f, old_sdf)
    out_w = jnp.where(do_update, merged_w, old_w)
    # eta is reported as −1 for untouched rays only through `updated`; keep raw
    # eta for the color gate below (reference returns eta even when skipping).
    return TsdfUpdate(sdf=out_sdf, w_depth=out_w, eta=jnp.where(valid, eta, -1.0), updated=do_update)


def update_voxel_color(
    old_clr: jnp.ndarray,  # [..., 3] float 0..1
    old_wc: jnp.ndarray,
    pt_world: jnp.ndarray,
    M_rgb: jnp.ndarray,  # [4,4] world→rgb-camera
    proj_rgb: jnp.ndarray,
    rgb: jnp.ndarray,  # [H, W, 3] float 0..1
    eta: jnp.ndarray,
    mu: float,
    max_w: int,
    depth_updated: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Color running average for voxels near the surface (reference:
    computeUpdatedVoxelColorInfo + the |eta/mu|<=0.25 gate in
    ComputeUpdatedVoxelInfo<true>)."""
    H, W = rgb.shape[:2]
    fx, fy, cx, cy = proj_rgb[0], proj_rgb[1], proj_rgb[2], proj_rgb[3]

    gate = depth_updated & ~((eta > mu) | (jnp.abs(eta / mu) > 0.25))

    pc = se3.apply(M_rgb, pt_world)
    z = jnp.where(pc[..., 2] == 0, 1e-6, pc[..., 2])
    u = fx * pc[..., 0] / z + cx
    v = fy * pc[..., 1] / z + cy
    gate &= (u >= 1) & (u <= W - 2) & (v >= 1) & (v <= H - 2)

    rgb_measure = bilinear(rgb, u, v)
    new_c = (old_clr * old_wc[..., None] + rgb_measure) / (old_wc + 1)[..., None]
    new_wc = jnp.minimum(old_wc + 1, max_w)

    out_c = jnp.where(gate[..., None], new_c, old_clr)
    out_wc = jnp.where(gate, new_wc, old_wc)
    return out_c, out_wc


def integrate_dense(
    vol_sdf: jnp.ndarray,
    vol_w: jnp.ndarray,
    pt_world: jnp.ndarray,
    M_d: jnp.ndarray,
    proj_d: jnp.ndarray,
    depth: jnp.ndarray,
    mu: float,
    max_w: int,
    stop_at_max_w: bool = False,
    vol_clr: Optional[jnp.ndarray] = None,
    vol_wc: Optional[jnp.ndarray] = None,
    M_rgb: Optional[jnp.ndarray] = None,
    proj_rgb: Optional[jnp.ndarray] = None,
    rgb: Optional[jnp.ndarray] = None,
):
    """One fused elementwise pass over a set of voxels (any shape)."""
    if stop_at_max_w:
        frozen = vol_w >= max_w
    upd = update_voxel_depth(vol_sdf, vol_w, pt_world, M_d, proj_d, depth, mu, max_w)
    sdf, w = upd.sdf, upd.w_depth
    if stop_at_max_w:
        sdf = jnp.where(frozen, vol_sdf, sdf)
        w = jnp.where(frozen, vol_w, w)
    if vol_clr is not None:
        clr, wc = update_voxel_color(
            vol_clr, vol_wc, pt_world, M_rgb, proj_rgb, rgb, upd.eta, mu, max_w, upd.updated
        )
        if stop_at_max_w:
            clr = jnp.where(frozen[..., None], vol_clr, clr)
            wc = jnp.where(frozen, vol_wc, wc)
        return sdf, w, clr, wc
    return sdf, w, None, None
