"""Photometric (color) tracking: residuals, Jacobians, LM energy.

Reference parity: DeviceAgnostic/ITMColorTracker.h (getColorDifferenceSq,
computePerPointGH_rt_Color — analytic Jacobian through the projection with
image gradients) and ITMColorTracker_CPU.cpp:14-100 (F/G sums with
occlusion rescaling noTotalPoints/countedPoints).

Colours are float 0..1 here; the reference's 255-scaled residuals only scale
the energy, and the trust-region quality ratio is scale-invariant.

The point cloud stays as [H, W, 4] maps (locations + colours with w-flag
validity) rather than the reference's compacted list — static shapes, no
prefix sums; skipPoints subsampling becomes a stride-2 mask.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp

from infinitam_tpu.ops.pixel import bilinear, in_bounds
from infinitam_tpu.utils import se3


class ColorFG(NamedTuple):
    f: jnp.ndarray  # scalar energy (occlusion-rescaled)
    nabla: jnp.ndarray  # [6]
    hessian: jnp.ndarray  # [6, 6] Gauss-Newton approximation
    num_valid: jnp.ndarray


def _project_points(locations, M, proj, img_size):
    H, W = img_size
    fx, fy, cx, cy = proj[0], proj[1], proj[2], proj[3]
    valid = locations[..., 3] > 0
    p_cam = (
        se3.apply(M, locations[..., :3])
    )
    z = p_cam[..., 2]
    valid &= z > 0
    zs = jnp.where(valid, z, 1.0)
    u = fx * p_cam[..., 0] / zs + cx
    v = fy * p_cam[..., 1] / zs + cy
    valid &= (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    return p_cam, jnp.clip(u, 0, W - 1), jnp.clip(v, 0, H - 1), valid


def color_f(
    locations: jnp.ndarray,  # [..., 4] world points (w=±1)
    colours: jnp.ndarray,  # [..., 4] known colours 0..1 (w=±1)
    rgb: jnp.ndarray,  # [H, W, 3] observed image at this level
    proj: jnp.ndarray,  # rgb intrinsics at this level
    M: jnp.ndarray,  # world→rgb-camera pose being evaluated
    point_mask: jnp.ndarray,  # [...] bool (skipPoints stride mask)
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Energy F = scale · Σ‖colour_obs − colour_known‖² (reference:
    F_oneLevel). Returns (f, num_valid)."""
    img_size = rgb.shape[:2]
    _p, u, v, valid = _project_points(locations, M, proj, img_size)
    valid &= point_mask & (colours[..., 3] > 0)
    obs = bilinear(rgb, u, v)
    diff = obs - colours[..., :3]
    per_point = jnp.sum(diff * diff, axis=-1)
    n_valid = jnp.sum(valid)
    n_total = jnp.sum(point_mask & (locations[..., 3] > 0) & (colours[..., 3] > 0))
    f_sum = jnp.sum(jnp.where(valid, per_point, 0.0))
    scale = jnp.where(n_valid > 0, n_total / jnp.maximum(n_valid, 1), 1.0)
    f = jnp.where(n_valid > 0, f_sum * scale, jnp.inf)
    return f, n_valid


def color_g(
    locations: jnp.ndarray,
    colours: jnp.ndarray,
    rgb: jnp.ndarray,
    gx: jnp.ndarray,  # [H, W, 3] image x-gradient at this level
    gy: jnp.ndarray,
    proj: jnp.ndarray,
    M: jnp.ndarray,
    point_mask: jnp.ndarray,
) -> ColorFG:
    """Gradient + GN Hessian (reference: computePerPointGH_rt_Color /
    G_oneLevel). Parameter order (tx,ty,tz,rx,ry,rz) with the perturbation
    M' = exp(δ)·M, matching the reference's ApplyDelta."""
    img_size = rgb.shape[:2]
    fx, fy = proj[0], proj[1]
    p_cam, u, v, valid = _project_points(locations, M, proj, img_size)
    valid &= point_mask & (colours[..., 3] > 0)

    obs = bilinear(rgb, u, v)
    gx_obs = bilinear(gx, u, v)
    gy_obs = bilinear(gy, u, v)
    diff_d = 2.0 * (obs - colours[..., :3])  # [..., 3]

    x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    zs = jnp.where(valid, z, 1.0)
    inv_z2 = 1.0 / (zs * zs)

    # d p_cam / d param_i (reference switch): translation = e_i, rotation =
    # e_i × p_cam
    zeros = jnp.zeros_like(x)
    ones = jnp.ones_like(x)
    dp = jnp.stack(
        [
            jnp.stack([ones, zeros, zeros], axis=-1),
            jnp.stack([zeros, ones, zeros], axis=-1),
            jnp.stack([zeros, zeros, ones], axis=-1),
            jnp.stack([zeros, -z, y], axis=-1),
            jnp.stack([z, zeros, -x], axis=-1),
            jnp.stack([-y, x, zeros], axis=-1),
        ],
        axis=-2,
    )  # [..., 6, 3]

    du = fx * (zs[..., None] * dp[..., 0] - dp[..., 2] * x[..., None]) * inv_z2[..., None]
    dv = fy * (zs[..., None] * dp[..., 1] - dp[..., 2] * y[..., None]) * inv_z2[..., None]
    # d colour / d param: [..., 6, 3]
    J = du[..., None] * gx_obs[..., None, :] + dv[..., None] * gy_obs[..., None, :]

    grad = jnp.sum(J * diff_d[..., None, :], axis=-1)  # [..., 6]
    hess = 2.0 * jnp.einsum("...ic,...jc->...ij", J, J, precision=se3.HIGHEST)  # [..., 6, 6]

    w = valid.astype(jnp.float32)
    n_valid = jnp.sum(valid)
    n_total = jnp.sum(point_mask & (locations[..., 3] > 0) & (colours[..., 3] > 0))
    scale = jnp.where(n_valid > 0, n_total / jnp.maximum(n_valid, 1), 1.0)

    flat_w = w.reshape(-1)
    nabla = jnp.einsum("n,ni->i", flat_w, grad.reshape(-1, 6), precision=se3.HIGHEST) * scale
    hessian = jnp.einsum("n,nij->ij", flat_w, hess.reshape(-1, 6, 6), precision=se3.HIGHEST) * scale

    obs_diff = obs - colours[..., :3]
    f_sum = jnp.sum(jnp.where(valid, jnp.sum(obs_diff * obs_diff, axis=-1), 0.0))
    f = jnp.where(n_valid > 0, f_sum * scale, jnp.inf)
    return ColorFG(f=f, nabla=nabla, hessian=hessian, num_valid=n_valid)


def skip_points_mask(shape: Tuple[int, int], skip: bool) -> jnp.ndarray:
    """Stride-2 point subsampling (reference: skipPoints uses every other
    point in both directions)."""
    H, W = shape
    if not skip:
        return jnp.ones((H, W), dtype=bool)
    ys = jnp.arange(H)[:, None] % 2 == 0
    xs = jnp.arange(W)[None, :] % 2 == 0
    return ys & xs
