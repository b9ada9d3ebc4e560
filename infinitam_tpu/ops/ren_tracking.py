"""Ren et al. 2012 SDF-based tracker: exp-SDF energy + MRP rotation LM.

Reference parity: DeviceAgnostic/ITMRenTracker.h:20-109 (computePerPixelEnergy
E = 4·e^{−6·dt}/(1+e^{−6·dt})², computeDDT central differences,
computePerPixelJacobian with the MRP ×4 rotation rows) and
ITMRenTracker.cpp:106-180 (minimalist LM: λ 1000, ×0.1 accept / ×10 reject,
MIN_STEP 5e-5, MIN_DECREASE 1e-4; delta applied as MRP-rotation matrix
left-multiplied onto invM; f = −Σ E is minimized).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from infinitam_tpu.ops.voxel_access import ReadFn, read_sdf_uninterpolated
from infinitam_tpu.utils import se3

DTUNE = 6.0


def mrp_rotation(r: jnp.ndarray) -> jnp.ndarray:
    """Modified-Rodrigues-parameter rotation matrix (reference:
    GetRotationMatrixFromMRP). r: [3] → [3,3] (row-major)."""
    t1, t2, t3 = r[0], r[1], r[2]
    tsq = t1 * t1 + t2 * t2 + t3 * t3
    tsum = 1.0 - tsq
    R = jnp.array(
        [
            [4 * t1 * t1 - 4 * t2 * t2 - 4 * t3 * t3 + tsum * tsum,
             8 * t1 * t2 - 4 * t3 * tsum,
             8 * t1 * t3 + 4 * t2 * tsum],
            [8 * t1 * t2 + 4 * t3 * tsum,
             4 * t2 * t2 - 4 * t1 * t1 - 4 * t3 * t3 + tsum * tsum,
             8 * t2 * t3 - 4 * t1 * tsum],
            [8 * t1 * t3 - 4 * t2 * tsum,
             8 * t2 * t3 + 4 * t1 * tsum,
             4 * t3 * t3 - 4 * t2 * t2 - 4 * t1 * t1 + tsum * tsum],
        ]
    )
    return R / ((1.0 + tsq) * (1.0 + tsq))


def delta_matrix(step: jnp.ndarray) -> jnp.ndarray:
    """4×4 increment from (t, mrp) step (reference: GetMFromParam /
    applyDelta — rotation from MRP, translation in the last row of the
    column-major matrix = translation column here)."""
    R = mrp_rotation(step[3:])
    M = jnp.eye(4)
    M = M.at[:3, :3].set(R)
    M = M.at[:3, 3].set(step[:3])
    return M


def unproject_view(depth: jnp.ndarray, proj: jnp.ndarray) -> jnp.ndarray:
    """Per-pixel camera-frame points [H,W,4] with w=±1 validity (reference:
    UnprojectDepthToCam)."""
    H, W = depth.shape
    fx, fy, cx, cy = proj[0], proj[1], proj[2], proj[3]
    valid = depth > 0
    d = jnp.where(valid, depth, 1.0)
    xs = jnp.arange(W, dtype=jnp.float32)[None, :]
    ys = jnp.arange(H, dtype=jnp.float32)[:, None]
    p = jnp.stack(
        [d * (xs - cx) / fx, d * (ys - cy) / fy, d], axis=-1
    )
    return jnp.concatenate([p, jnp.where(valid, 1.0, -1.0)[..., None]], axis=-1)


def energy(read: ReadFn, pts_cam: jnp.ndarray, inv_M: jnp.ndarray, one_over_voxel: float):
    """f = −Σ E over valid points (reference: F_oneLevel). Uses trilinear SDF
    reads — the reference ships the uninterpolated variant with the
    interpolated one commented out as "theoretically better"
    (ITMRenTracker.h:27-31); the smooth field is what makes the analytic
    gradient meaningful, so we take the better variant."""
    from infinitam_tpu.ops.voxel_access import read_sdf_interpolated

    valid = pts_cam[..., 3] > -1.0
    pw = se3.apply(inv_M, pts_cam[..., :3])
    pv = pw * one_over_voxel
    dt, found = read_sdf_interpolated(read, pv)
    expdt = jnp.exp(-dt * DTUNE)
    e = 4.0 * expdt / ((expdt + 1.0) ** 2)
    e = jnp.where(valid & found & (dt < 1.0), e, 0.0)
    return -jnp.sum(e)


def gradient_hessian(
    read: ReadFn, pts_cam: jnp.ndarray, inv_M: jnp.ndarray, one_over_voxel: float
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(∇f [6], GN Hessian [6,6]) (reference: computePerPixelJacobian +
    G_oneLevel — gradient rows j, H = Σ j jᵀ; with f = −Σ E the gradient
    accumulates −j). Unlike the reference we keep the 1/voxelSize metric
    factor so translation steps are true metres."""
    from infinitam_tpu.ops.voxel_access import read_sdf_interpolated

    valid = pts_cam[..., 3] > -1.0
    c = se3.apply(inv_M, pts_cam[..., :3])
    pv = c * one_over_voxel
    dt, found = read_sdf_interpolated(read, pv)
    ok = valid & found & (dt < 1.0)

    ddt = []
    ddt_ok = ok
    for axis in range(3):
        e = jnp.zeros((3,), dtype=pv.dtype).at[axis].set(1.0)
        d1, f1 = read_sdf_interpolated(read, pv + e)
        d2, f2 = read_sdf_interpolated(read, pv - e)
        ddt_ok &= f1 & f2 & (d1 < 1.0) & (d2 < 1.0)
        ddt.append((d1 - d2) * 0.5)
    dDt = jnp.stack(ddt, axis=-1)

    expdt = jnp.exp(-dt * DTUNE)
    deto = expdt + 1.0
    prefix = 4.0 * DTUNE * (
        2.0 * jnp.exp(-dt * 2.0 * DTUNE) / (deto**3) - expdt / (deto**2)
    )
    # dE/d p_world in metres: SDF central difference is per-voxel → ×1/voxel
    g = dDt * (prefix * one_over_voxel)[..., None]

    jx, jy, jz = g[..., 0], g[..., 1], g[..., 2]
    cx_, cy_, cz_ = c[..., 0], c[..., 1], c[..., 2]
    j = jnp.stack(
        [
            jx,
            jy,
            jz,
            4.0 * (jz * cy_ - jy * cz_),
            4.0 * (jx * cz_ - jz * cx_),
            4.0 * (jy * cx_ - jx * cy_),
        ],
        axis=-1,
    )
    w = ddt_ok.astype(jnp.float32)[..., None]
    jm = (j * w).reshape(-1, 6)
    nabla = -jnp.sum(jm, axis=0)  # ∇(−ΣE) = −Σ j
    H = jnp.einsum("ni,nj->ij", jm, jm.reshape(-1, 6), preferred_element_type=jnp.float32, precision=se3.HIGHEST)
    return nabla, H
