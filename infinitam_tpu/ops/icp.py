"""Point-to-plane ICP: per-pixel residuals/Jacobians + Gauss-Newton machinery.

Reference parity:
- residual/Jacobian: DeviceAgnostic/ITMDepthTracker.h:8-105
  (computePerPointGH_Depth_Ab / computePerPointGH_Depth) and the weighted
  variant DeviceAgnostic/ITMWeightedICPTracker.h.
- reduction + f: ITMDepthTracker_CPU.cpp:14-79 (ComputeGandH —
  f = N>100 ? √(Σb²)/N : 1e5; hessian/nabla summed over valid pixels).
- solve/update: ITMDepthTracker.cpp:85-143 (ComputeDelta Cholesky 6×6/3×3,
  ApplyDelta small-angle Tinc, Levenberg λ accept/reject in TrackCamera).

Design: the per-pixel (b, A) terms form a [N, 6] Jacobian; the normal
equations are one [6, N]@[N, 6] matmul (`einsum ni,nj`, full float32). The
entire level loop, λ adaptation and the 6×6 solve run inside one jitted
program, so no host code decides per iteration as ITMDepthTracker_CUDA.cu:99
does (XLA's GPU while loop still copies its predicate to the host each
iteration).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from infinitam_tpu.ops.pixel import bilinear_with_holes_vec
from infinitam_tpu.utils import se3

MODE_ROTATION = "rotation"
MODE_TRANSLATION = "translation"
MODE_BOTH = "both"


class GHResult(NamedTuple):
    f: jnp.ndarray  # scalar: √(Σb²)/N, or 1e5 when N ≤ min_valid
    nabla: jnp.ndarray  # [6]
    hessian: jnp.ndarray  # [6, 6]
    num_valid: jnp.ndarray  # scalar int


def compute_residuals(
    depth: jnp.ndarray,  # [H, W] metric depth at the current pyramid level
    view_proj: jnp.ndarray,  # (fx, fy, cx, cy) at this level
    points_map: jnp.ndarray,  # [Hs, Ws, 4] scene points (metres, w=±1)
    normals_map: jnp.ndarray,  # [Hs, Ws, 4] scene normals
    scene_proj: jnp.ndarray,  # (fx, fy, cx, cy) at this level
    approx_inv_pose: jnp.ndarray,  # [4,4] camera→world, current estimate
    scene_pose: jnp.ndarray,  # [4,4] world→camera of the raycast maps
    dist_thresh: float,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """All-pixel residuals b [H,W], Jacobian rows A [H,W,6], valid mask, and
    the world-frame point p (for the weighted variant).

    A layout matches the reference step layout: A[0:3] = n×p (rotation),
    A[3:6] = n (translation).
    """
    H, W = depth.shape
    Hs, Ws = points_map.shape[:2]
    vfx, vfy, vcx, vcy = view_proj[0], view_proj[1], view_proj[2], view_proj[3]
    sfx, sfy, scx, scy = scene_proj[0], scene_proj[1], scene_proj[2], scene_proj[3]

    valid = depth > 1e-8

    xs = jnp.arange(W, dtype=jnp.float32)[None, :].repeat(H, axis=0)
    ys = jnp.arange(H, dtype=jnp.float32)[:, None].repeat(W, axis=1)
    d = jnp.where(valid, depth, 1.0)
    p_cam = jnp.stack(
        [d * (xs - vcx) / vfx, d * (ys - vcy) / vfy, d], axis=-1
    )
    p = se3.apply(approx_inv_pose, p_cam)

    p_scene = se3.apply(scene_pose, p)
    z = p_scene[..., 2]
    valid &= z > 0
    zs = jnp.where(valid, z, 1.0)
    u = sfx * p_scene[..., 0] / zs + scx
    v = sfy * p_scene[..., 1] / zs + scy
    valid &= (u >= 0) & (u <= Ws - 2) & (v >= 0) & (v <= Hs - 2)

    uc = jnp.clip(u, 0.0, Ws - 2.0)
    vc = jnp.clip(v, 0.0, Hs - 2.0)
    target_pt, pt_ok = bilinear_with_holes_vec(points_map, uc, vc)
    valid &= pt_ok

    diff = target_pt[..., :3] - p
    dist = jnp.sum(diff * diff, axis=-1)
    valid &= dist <= dist_thresh

    target_n, _n_ok = bilinear_with_holes_vec(normals_map, uc, vc)
    n = target_n[..., :3]

    b = jnp.sum(n * diff, axis=-1)
    a_rot = jnp.cross(n, p)  # n×p, matches reference A[0..2]
    A = jnp.concatenate([a_rot, n], axis=-1)
    return b, A, valid, p


def reduce_gh(
    b: jnp.ndarray,
    A: jnp.ndarray,
    valid: jnp.ndarray,
    min_valid: int = 100,
    weights: Optional[jnp.ndarray] = None,
) -> GHResult:
    """Normal-equation reduction: one masked matmul over the pixel axis.

    weights: optional per-pixel scale w applied to the Jacobian rows
    (reference DeviceAgnostic/ITMWeightedICPTracker.h scales the
    correspondence normal: H += (wA)(wA)ᵀ, ∇ += b·(wA), f += (wb)²).
    """
    w = valid.astype(b.dtype)
    if weights is not None:
        w = w * weights
    Af = A.reshape(-1, 6) * w.reshape(-1, 1)
    bf = b.reshape(-1) * w.reshape(-1)
    b_valid = b.reshape(-1) * valid.astype(b.dtype).reshape(-1)
    # Σ (wA)(wA)ᵀ as a [6,N]@[N,6] matmul — mask folded into Af.
    hessian = jnp.einsum("ni,nj->ij", Af, Af, preferred_element_type=jnp.float32, precision=se3.HIGHEST)
    nabla = jnp.einsum("n,ni->i", b_valid, Af, preferred_element_type=jnp.float32, precision=se3.HIGHEST)
    sum_f = jnp.sum(bf * bf)
    n_valid = jnp.sum(valid)
    f = jnp.where(n_valid > min_valid, jnp.sqrt(jnp.abs(sum_f)) / jnp.maximum(n_valid, 1), 1e5)
    return GHResult(f=f, nabla=nabla, hessian=hessian, num_valid=n_valid)


def solve_delta(
    nabla: jnp.ndarray, hessian: jnp.ndarray, lam: jnp.ndarray, mode: str
) -> jnp.ndarray:
    """Levenberg-damped solve → step[6] in the reference's ApplyDelta layout
    (step[0:3] rotation, step[3:6] translation).

    Reference: TrackCamera damping `A[i+i*6] *= 1+λ` + ComputeDelta Cholesky.
    """
    if mode == MODE_BOTH:
        Amat = hessian * (1.0 + lam * jnp.eye(6, dtype=hessian.dtype))
        step = _solve_psd(Amat, nabla)
        return step
    if mode == MODE_ROTATION:
        sub = hessian[:3, :3]
        g = nabla[:3]
    else:  # translation
        sub = hessian[3:, 3:]
        g = nabla[3:]
    Amat = sub * (1.0 + lam * jnp.eye(3, dtype=hessian.dtype))
    s = _solve_psd(Amat, g)
    if mode == MODE_ROTATION:
        return jnp.concatenate([s, jnp.zeros(3, dtype=s.dtype)])
    return jnp.concatenate([jnp.zeros(3, dtype=s.dtype), s])


def _solve_psd(Amat: jnp.ndarray, g: jnp.ndarray) -> jnp.ndarray:
    """Cholesky solve with a singularity guard (zero step on failure).

    UNROLLED scalar Cholesky + substitution, mirroring the reference's own
    ORUtils/Cholesky.h:16-67: at 6×6 the unrolled form fuses into one
    elementwise graph instead of a Cholesky and two triangular-solve calls
    per GN iteration."""
    n = Amat.shape[0]
    a = [[Amat[i, j] for j in range(n)] for i in range(n)]
    L = [[None] * n for _ in range(n)]
    ok = jnp.asarray(True)
    tiny = jnp.asarray(1e-20, Amat.dtype)
    for j in range(n):
        s = a[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        ok = ok & (s > tiny)
        d = jnp.sqrt(jnp.maximum(s, tiny))
        L[j][j] = d
        for i in range(j + 1, n):
            s2 = a[i][j]
            for k in range(j):
                s2 = s2 - L[i][k] * L[j][k]
            L[i][j] = s2 / d
    y = [None] * n
    for i in range(n):
        s = g[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    sol = jnp.stack(x)
    return jnp.where(ok & jnp.all(jnp.isfinite(sol)), sol, jnp.zeros_like(g))


# ---------------------------------------------------------------------------
# Scalarized GN-iteration helpers (the tracker's inner-loop representation).
#
# The GN loop carries its pose (12 scalars, row-major [R|t]), hessian (36)
# and nabla (6) as Python tuples of 0-d values, crosses into array land ONCE
# per iteration (the residual pass + reduction), and extracts back ONCE; the
# accept/reject, damped solve and SE3 update between are one scalar graph.
# (Whether this form still beats the array form of solve_delta /
# apply_delta below on a GPU is open — ROADMAP D2.)
# ---------------------------------------------------------------------------


def pose12_from_mat(M: jnp.ndarray):
    """[4,4] → tuple of 12 scalars (rows of [R|t], row-major)."""
    return tuple(M[i, j] for i in range(3) for j in range(4))


def mat_from_pose12(p) -> jnp.ndarray:
    """tuple of 12 scalars → [4,4] (built by stacking scalars)."""
    z = p[0] * 0.0
    rows = [jnp.stack([p[4 * i + j] for j in range(4)]) for i in range(3)]
    rows.append(jnp.stack([z, z, z, z + 1.0]))
    return jnp.stack(rows)


def _chol_solve_scalars(a, g):
    """Unrolled scalar Cholesky solve (reference ORUtils/Cholesky.h:16-67).
    a: n×n nested list of scalars, g: list of n scalars.
    Returns (x list, ok scalar bool)."""
    n = len(g)
    L = [[None] * n for _ in range(n)]
    ok = None
    tiny = 1e-20
    for j in range(n):
        s = a[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        okj = s > tiny
        ok = okj if ok is None else (ok & okj)
        d = jnp.sqrt(jnp.maximum(s, tiny))
        L[j][j] = d
        for i in range(j + 1, n):
            s2 = a[i][j]
            for k in range(j):
                s2 = s2 - L[i][k] * L[j][k]
            L[i][j] = s2 / d
    y = [None] * n
    for i in range(n):
        s = g[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    for xi in x:
        ok = ok & jnp.isfinite(xi)
    return x, ok


def solve_delta_scalars(nabla, hessian, lam, mode):
    """solve_delta on scalar tuples: nabla len-6, hessian 6×6 nested list,
    lam scalar. Returns a len-6 list of step scalars (zero on failure)."""
    if mode == MODE_BOTH:
        idx = [0, 1, 2, 3, 4, 5]
    elif mode == MODE_ROTATION:
        idx = [0, 1, 2]
    else:
        idx = [3, 4, 5]
    a = [
        [
            hessian[i][j] * (1.0 + lam) if i == j else hessian[i][j]
            for j in idx
        ]
        for i in idx
    ]
    x, ok = _chol_solve_scalars(a, [nabla[i] for i in idx])
    zero = nabla[0] * 0.0
    step = [zero] * 6
    for pos, i in enumerate(idx):
        step[i] = jnp.where(ok, x[pos], 0.0)
    return step


def apply_delta_scalars(p, step):
    """apply_delta on a 12-scalar pose: Tinc(step) @ P, scalar graph."""
    w0, w1, w2, t0, t1, t2 = step
    tinc = [
        [1.0, w2, -w1, t0],
        [-w2, 1.0, w0, t1],
        [w1, -w0, 1.0, t2],
    ]
    P = [[p[4 * i + j] for j in range(4)] for i in range(3)]
    out = []
    for i in range(3):
        for j in range(4):
            s = sum(tinc[i][k] * P[k][j] for k in range(3))
            if j == 3:
                s = s + tinc[i][3]
            out.append(s)
    return tuple(out)


def coerce_scalars(p):
    """se3.coerce on a 12-scalar pose (two scalar Newton iterations)."""
    r = [[p[4 * i + j] for j in range(3)] for i in range(3)]
    for _ in range(2):
        rtr = [
            [sum(r[k][i] * r[k][j] for k in range(3)) for j in range(3)]
            for i in range(3)
        ]
        n = [
            [(1.5 if i == j else 0.0) - 0.5 * rtr[i][j] for j in range(3)]
            for i in range(3)
        ]
        r = [
            [sum(r[i][k] * n[k][j] for k in range(3)) for j in range(3)]
            for i in range(3)
        ]
    return tuple(
        r[i][j] if j < 3 else p[4 * i + 3]
        for i in range(3)
        for j in range(4)
    )


def has_converged_scalars(step, threshold: float):
    ss = sum(si * si for si in step)
    return jnp.sqrt(ss) / 6.0 < threshold


def apply_delta(approx_inv_pose: jnp.ndarray, step: jnp.ndarray) -> jnp.ndarray:
    """Left-multiply the small-angle increment onto the camera→world pose
    (reference: ApplyDelta — Tinc rotation part is I − [ω]× in row-major
    terms, translation step[3:6]).

    Scalar-unrolled (no 4×4 matmul or skew build)."""
    P = approx_inv_pose
    w0, w1, w2 = step[0], step[1], step[2]
    # Tinc rows: [1, w2, −w1 | t0], [−w2, 1, w0 | t1], [w1, −w0, 1 | t2]
    tinc = [
        [1.0, w2, -w1, step[3]],
        [-w2, 1.0, w0, step[4]],
        [w1, -w0, 1.0, step[5]],
    ]
    rows = [
        jnp.stack([
            sum(tinc[i][k] * P[k, j] for k in range(3))
            + (tinc[i][3] if j == 3 else 0.0)
            for j in range(4)
        ])
        for i in range(3)
    ]
    last = jnp.array([0.0, 0.0, 0.0, 1.0], dtype=P.dtype)
    return jnp.stack(rows + [last])


def has_converged(step: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """|step|/6 < threshold (reference: HasConverged). Scalar-unrolled sum."""
    ss = sum(step[i] * step[i] for i in range(6))
    return jnp.sqrt(ss) / 6.0 < threshold
