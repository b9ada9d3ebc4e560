"""SE(3) utilities — exp/log maps, small-angle increments, re-orthonormalization.

Functional, jittable equivalents of the reference's pose object
(reference: ITMLib/Objects/ITMPose.{h,cpp} — SetModelViewFromParams:84,
SetParamsFromModelView, Coerce). Poses are 4x4 row-major matrices M mapping
world→camera ("modelview"); twists are 6-vectors (t, ω) with translation first,
matching the reference's (tx,ty,tz,rx,ry,rz) parameter order.

All functions broadcast over leading batch dimensions.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Every product on poses, points and normal equations runs in full float32:
# on a GPU, float32 products otherwise default to TF32 (~3 decimal digits),
# which leaves rotations visibly non-orthonormal after a few frames.
HIGHEST = jax.lax.Precision.HIGHEST


def matmul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """`a @ b` in full float32 precision."""
    return jnp.matmul(a, b, precision=HIGHEST)


def skew(w: jnp.ndarray) -> jnp.ndarray:
    """[ω]× such that skew(w) @ v == cross(w, v). w: (..., 3) → (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([z, -wz, wy], axis=-1),
            jnp.stack([wz, z, -wx], axis=-1),
            jnp.stack([-wy, wx, z], axis=-1),
        ],
        axis=-2,
    )


def so3_exp(w: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues with Taylor fallback for small angles. (...,3) → (...,3,3)."""
    theta_sq = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta_sq)
    # Series coefficients (reference: ITMPose.cpp:84-150 uses the same guarded
    # series: A=sinθ/θ, B=(1−cosθ)/θ²).
    small = theta_sq < 1e-8
    A = jnp.where(small, 1.0 - theta_sq / 6.0, jnp.sin(theta) / jnp.where(small, 1.0, theta))
    B = jnp.where(
        small, 0.5 - theta_sq / 24.0, (1.0 - jnp.cos(theta)) / jnp.where(small, 1.0, theta_sq)
    )
    W = skew(w)
    WW = matmul(W, W)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + A[..., None, None] * W + B[..., None, None] * WW


def se3_exp(twist: jnp.ndarray) -> jnp.ndarray:
    """Twist (t, ω) → 4x4 transform. (...,6) → (...,4,4)."""
    t, w = twist[..., :3], twist[..., 3:]
    theta_sq = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta_sq)
    small = theta_sq < 1e-8
    A = jnp.where(small, 1.0 - theta_sq / 6.0, jnp.sin(theta) / jnp.where(small, 1.0, theta))
    B = jnp.where(
        small, 0.5 - theta_sq / 24.0, (1.0 - jnp.cos(theta)) / jnp.where(small, 1.0, theta_sq)
    )
    C = jnp.where(
        small, 1.0 / 6.0 - theta_sq / 120.0, (1.0 - A) / jnp.where(small, 1.0, theta_sq)
    )
    W = skew(w)
    WW = matmul(W, W)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=twist.dtype), W.shape)
    R = eye + A[..., None, None] * W + B[..., None, None] * WW
    V = eye + B[..., None, None] * W + C[..., None, None] * WW
    T = jnp.einsum("...ij,...j->...i", V, t, precision=HIGHEST)
    return pack_rt(R, T)


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix → axis-angle vector. (...,3,3) → (...,3)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    # antisymmetric part
    v = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    # θ via atan2(|v|/2, (tr−1)/2): much better float32 conditioning than
    # arccos across the whole range
    sin_theta = 0.5 * jnp.linalg.norm(v, axis=-1)
    theta = jnp.arctan2(sin_theta, cos_theta)
    small = theta < 1e-5
    # v = 2 sinθ * axis;  ω = θ * axis
    scale = jnp.where(
        small,
        0.5 + theta * theta / 12.0,
        theta / jnp.where(small, 1.0, 2.0 * sin_theta),
    )
    # Near θ=π the antisymmetric part vanishes; recover axis from the symmetric
    # part. (Rare in tracking; handled for log-map robustness.)
    near_pi = theta > 3.1
    diag = jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
    axis_sq = jnp.clip((diag - cos_theta[..., None]) / (1.0 - cos_theta[..., None] + 1e-12), 0.0, 1.0)
    axis = jnp.sqrt(axis_sq)
    # fix signs from off-diagonals (largest-axis convention)
    sign_fix = jnp.sign(
        jnp.stack(
            [
                R[..., 2, 1] - R[..., 1, 2],
                R[..., 0, 2] - R[..., 2, 0],
                R[..., 1, 0] - R[..., 0, 1],
            ],
            axis=-1,
        )
        + 1e-30
    )
    w_near_pi = theta[..., None] * axis * sign_fix
    return jnp.where(near_pi[..., None], w_near_pi, scale[..., None] * v)


def se3_log(M: jnp.ndarray) -> jnp.ndarray:
    """4x4 transform → twist (t, ω). Inverse of se3_exp."""
    R = M[..., :3, :3]
    T = M[..., :3, 3]
    w = so3_log(R)
    theta_sq = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta_sq)
    small = theta_sq < 1e-8
    A = jnp.where(small, 1.0 - theta_sq / 6.0, jnp.sin(theta) / jnp.where(small, 1.0, theta))
    B = jnp.where(
        small, 0.5 - theta_sq / 24.0, (1.0 - jnp.cos(theta)) / jnp.where(small, 1.0, theta_sq)
    )
    W = skew(w)
    WW = matmul(W, W)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=M.dtype), W.shape)
    # V^{-1} = I - W/2 + (1/θ²)(1 - A/(2B)) W²
    coef = jnp.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0,
        (1.0 - A / (2.0 * B)) / jnp.where(small, 1.0, theta_sq),
    )
    Vinv = eye - 0.5 * W + coef[..., None, None] * WW
    t = jnp.einsum("...ij,...j->...i", Vinv, T, precision=HIGHEST)
    return jnp.concatenate([t, w], axis=-1)


def pack_rt(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """(...,3,3),(...,3) → (...,4,4)."""
    batch = R.shape[:-2]
    M = jnp.zeros(batch + (4, 4), dtype=R.dtype)
    M = M.at[..., :3, :3].set(R)
    M = M.at[..., :3, 3].set(t)
    M = M.at[..., 3, 3].set(1.0)
    return M


def invert(M: jnp.ndarray) -> jnp.ndarray:
    """Rigid-transform inverse: (R,t) → (Rᵀ, −Rᵀt)."""
    R = M[..., :3, :3]
    t = M[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    return pack_rt(Rt, -jnp.einsum("...ij,...j->...i", Rt, t, precision=HIGHEST))


def small_delta(step: jnp.ndarray) -> jnp.ndarray:
    """First-order incremental transform from step (ω, t) — note rotation-first
    to match the tracker's step layout (reference: ITMDepthTracker.cpp:115-143
    builds Tinc from step[0:3]=rotation, step[3:6]=translation)."""
    w, t = step[..., :3], step[..., 3:]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=step.dtype), w.shape[:-1] + (3, 3))
    return pack_rt(eye + skew(w), t)


def coerce(M: jnp.ndarray) -> jnp.ndarray:
    """Re-orthonormalize the rotation part after incremental updates
    (reference: ITMPose::Coerce — log/exp round trip). Uses a polar-like
    Newton iteration which is cheap, jit-friendly, and batch-safe.

    Unbatched 4×4 inputs take a fully scalar-unrolled path, which fuses
    into the tracker's per-iteration scalar graph."""
    if M.ndim == 2 and M.shape == (4, 4):
        r = [[M[i, j] for j in range(3)] for i in range(3)]
        for _ in range(2):
            # RtR = RᵀR; R ← R(1.5 I − 0.5 RtR), all scalar
            rtr = [
                [sum(r[k][i] * r[k][j] for k in range(3)) for j in range(3)]
                for i in range(3)
            ]
            n = [
                [
                    (1.5 if i == j else 0.0) - 0.5 * rtr[i][j]
                    for j in range(3)
                ]
                for i in range(3)
            ]
            r = [
                [sum(r[i][k] * n[k][j] for k in range(3)) for j in range(3)]
                for i in range(3)
            ]
        rows = [
            jnp.stack([r[i][0], r[i][1], r[i][2], M[i, 3]]) for i in range(3)
        ]
        last = jnp.array([0.0, 0.0, 0.0, 1.0], dtype=M.dtype)
        return jnp.stack(rows + [last])
    R = M[..., :3, :3]
    t = M[..., :3, 3]
    # two Newton iterations of R ← R(3I − RᵀR)/2 converge fast for near-orthonormal R
    for _ in range(2):
        RtR = matmul(jnp.swapaxes(R, -1, -2), R)
        eye = jnp.broadcast_to(jnp.eye(3, dtype=M.dtype), RtR.shape)
        R = matmul(R, 1.5 * eye - 0.5 * RtR)
    return pack_rt(R, t)


def rotate(M: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Apply only the rotation part to vectors (normals): (...,4,4) or
    (...,3,3), (...,3) → (...,3).

    Written as elementwise multiply-adds rather than a product: a K=3
    contraction over a whole image or voxel batch fuses with its
    neighbours this way and stays exact float32, where a GEMM library call
    would be slow (and TF32 at default precision on a GPU)."""
    R = M[..., :3, :3]
    return jnp.stack(
        [R[..., i, 0] * v[..., 0] + R[..., i, 1] * v[..., 1] + R[..., i, 2] * v[..., 2]
         for i in range(3)],
        axis=-1,
    )


def apply(M: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Apply rigid transform to points: (...,4,4),(...,3) → (...,3)."""
    return rotate(M, p) + M[..., :3, 3]
