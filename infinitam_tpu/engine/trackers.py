"""Camera trackers: hierarchical Gauss-Newton depth ICP (+ variants).

Reference parity: ITMLib/Engine/ITMDepthTracker.{h,cpp} (TrackCamera:145-199 —
coarse→fine level sweep, per-level Levenberg accept/reject loop, small-angle
updates, |step|/6 convergence), ITMTrackerFactory.h (tracker selection),
ITMCompositeTracker.h, ITMExternalTracker.cpp, ITMIMUTracker.cpp.

Design: the whole TrackCamera runs as ONE jitted function. Levels unroll
statically (shapes differ per level); the per-level iteration loop is a
`lax.while_loop` whose body evaluates residuals, reduces the 6×6 normal
equations with one matmul, adapts λ, solves, and applies the increment — all
in the one program (XLA's GPU while loop still reads its predicate on the
host each iteration). Batched sequences vmap over this.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from infinitam_tpu.config import TrackingParams
from infinitam_tpu.ops import icp
from infinitam_tpu.ops.pyramid import build_depth_pyramid, subsample_with_holes
from infinitam_tpu.utils import se3


class TrackResult(NamedTuple):
    pose: jnp.ndarray  # [4,4] world→camera (pose_d.M)
    f: jnp.ndarray  # final energy at the finest level
    num_valid: jnp.ndarray  # valid points at the finest level


def level_modes(params: TrackingParams) -> List[str]:
    """Iteration type per level, index 0 = finest (reference:
    ITMLibSettings.cpp trackingRegime — BOTH at fine levels, ROTATION at the
    `n_rotation_only_levels` coarsest)."""
    modes = []
    for lvl in range(params.n_levels):
        if lvl >= params.n_levels - params.n_rotation_only_levels:
            modes.append(icp.MODE_ROTATION)
        else:
            modes.append(icp.MODE_BOTH)
    return modes


def level_dist_thresh(params: TrackingParams) -> List[float]:
    """Per-level ICP gate, index 0 = finest (reference: ITMDepthTracker.cpp:25-28
    — coarsest = distThresh, each finer level −distThresh/n_levels)."""
    n = params.n_levels
    step = params.dist_thresh / n
    out = [0.0] * n
    out[n - 1] = params.dist_thresh
    for lvl in range(n - 2, -1, -1):
        out[lvl] = out[lvl + 1] - step
    return out


def level_iterations(params: TrackingParams) -> List[int]:
    """Iterations per level, index 0 = finest, from config (reference
    hardcodes 2, +2 per coarser level — ITMDepthTracker.cpp:19-23; the config
    default matches). Missing entries extend by +2 like the reference."""
    out = list(params.iterations_per_level[: params.n_levels])
    while len(out) < params.n_levels:
        out.append((out[-1] if out else 0) + 2)
    return out


def scale_proj(proj: jnp.ndarray, level: int) -> jnp.ndarray:
    """Intrinsics at pyramid level (halved per level; reference:
    PrepareForEvaluation `intrinsics * 0.5f`)."""
    return proj * (0.5**level)


def track_depth(
    pose: jnp.ndarray,  # [4,4] world→camera initial estimate (previous frame)
    depth: jnp.ndarray,  # [H, W] metric depth, −1 invalid
    view_proj: jnp.ndarray,  # (fx, fy, cx, cy) of the depth camera
    points_map: jnp.ndarray,  # [H, W, 4] raycasted scene points (metres)
    normals_map: jnp.ndarray,  # [H, W, 4]
    scene_pose: jnp.ndarray,  # [4,4] world→camera pose of the raycast maps
    params: TrackingParams,
    weights_map: Optional[jnp.ndarray] = None,  # [H, W] per-pixel ICP weights
) -> TrackResult:
    """Hierarchical GN point-to-plane ICP (reference: TrackCamera).

    Scene maps stay at full resolution for every level — the reference only
    subsamples the view depth and halves intrinsics (ITMDepthTracker.cpp:62-76,
    the scene FilterSubsample calls are commented out upstream).
    """
    modes = level_modes(params)
    dists = level_dist_thresh(params)
    iters = level_iterations(params)

    depth_pyr = build_depth_pyramid(depth, params.n_levels)
    # weights_map carries σ_z (depth uncertainty); the per-pixel ICP weight is
    # minσ/σ·0.5 + 0.5 ∈ (0.5, 1] (reference: ITMWeightedICPTracker_CPU.cpp:43)
    weight_pyr: List[Optional[jnp.ndarray]] = []
    if weights_map is not None:
        sigma_pyr = [weights_map]
        for _ in range(params.n_levels - 1):
            sigma_pyr.append(subsample_with_holes(sigma_pyr[-1]))
        for sig in sigma_pyr:
            pos = sig > 0
            min_sigma = jnp.min(jnp.where(pos, sig, jnp.inf))
            weight_pyr.append(jnp.where(pos, min_sigma / jnp.maximum(sig, 1e-12) * 0.5 + 0.5, 0.0))
    else:
        weight_pyr = [None] * params.n_levels

    inv_pose = se3.invert(pose)
    f_final = jnp.array(1e5, dtype=jnp.float32)
    n_final = jnp.array(0, dtype=jnp.int32)

    for lvl in range(params.n_levels - 1, params.no_icp_run_till_level - 1, -1):
        mode = modes[lvl]
        d_lvl = depth_pyr[lvl]
        w_lvl = weight_pyr[lvl]
        vproj = scale_proj(view_proj, lvl)
        dist_thresh = dists[lvl]
        n_iter = iters[lvl]

        # Scalar GN state (see ops/icp.py "Scalarized GN-iteration
        # helpers"): the loop carries pose/hessian/nabla as tuples of 0-d
        # scalars so the accept/reject + damped solve + SE3 update run as a
        # pure scalar graph around the one residual + reduction pass.
        def body(_i, s, *, d_lvl=d_lvl, vproj=vproj, mode=mode,
                 dist_thresh=dist_thresh, w_lvl=w_lvl):
            (ip, ip_good, f_old0, h_good0, g_good0, lam0, done0,
             f_last0, n_last0) = s
            ip_mat = icp.mat_from_pose12(ip)
            b, A, valid, _p = icp.compute_residuals(
                d_lvl,
                vproj,
                points_map,
                normals_map,
                view_proj,  # scene maps are full-res → level-0 intrinsics
                ip_mat,
                scene_pose,
                dist_thresh,
            )
            gh = icp.reduce_gh(b, A, valid, params.min_valid_points, weights=w_lvl)

            # ONE array→scalar crossing: extract f, N, ∇, H as scalars
            f = gh.f
            n_valid = gh.num_valid
            h = [[gh.hessian[i, j] for j in range(6)] for i in range(6)]
            g = [gh.nabla[i] for i in range(6)]

            reject = (n_valid <= 0) | (f > f_old0)
            nv = jnp.maximum(n_valid, 1).astype(jnp.float32)
            h_good = tuple(
                jnp.where(reject, h_good0[6 * i + j], h[i][j] / nv)
                for i in range(6) for j in range(6)
            )
            g_good = tuple(
                jnp.where(reject, g_good0[i], g[i] / nv) for i in range(6)
            )
            f_old = jnp.where(reject, f_old0, f)
            lam = jnp.where(reject, lam0 * 10.0, lam0 / 10.0)
            ip_base = tuple(
                jnp.where(reject, ip_good[k], ip[k]) for k in range(12)
            )

            step = icp.solve_delta_scalars(
                g_good, [[h_good[6 * i + j] for j in range(6)] for i in range(6)],
                lam, mode,
            )
            new_ip = icp.coerce_scalars(icp.apply_delta_scalars(ip_base, step))
            converged = icp.has_converged_scalars(
                step, params.termination_threshold
            )

            frozen = done0
            return (
                tuple(jnp.where(frozen, ip[k], new_ip[k]) for k in range(12)),
                tuple(jnp.where(frozen, ip_good[k], ip_base[k]) for k in range(12)),
                jnp.where(frozen, f_old0, f_old),
                tuple(jnp.where(frozen, h_good0[k], h_good[k]) for k in range(36)),
                tuple(jnp.where(frozen, g_good0[k], g_good[k]) for k in range(6)),
                jnp.where(frozen, lam0, lam),
                done0 | converged,
                jnp.where(frozen, f_last0, f),
                jnp.where(frozen, n_last0, n_valid),
            )

        ip0 = icp.pose12_from_mat(inv_pose)
        zero = jnp.float32(0.0)
        init = (
            ip0,
            ip0,
            jnp.array(1e20, dtype=jnp.float32),
            tuple(zero for _ in range(36)),
            tuple(zero for _ in range(6)),
            jnp.array(1.0, dtype=jnp.float32),
            jnp.array(False),
            jnp.array(1e5, dtype=jnp.float32),
            jnp.array(0, dtype=jnp.int32),
        )
        # early-exit loop (the reference breaks on HasConverged,
        # ITMDepthTracker.cpp:190-193): converged levels skip their remaining
        # residual passes entirely instead of running them masked
        final = jax.lax.while_loop(
            lambda c: (c[0] < n_iter) & ~c[1][6],
            lambda c: (c[0] + 1, body(c[0], c[1])),
            (jnp.int32(0), init),
        )[1]
        # the level hands the CURRENT pose to the next level (reference keeps
        # approxInvPose across levels via trackingState->pose_d)
        inv_pose = icp.mat_from_pose12(final[0])
        f_final = final[7]
        n_final = final[8]

    return TrackResult(pose=se3.invert(se3.coerce(inv_pose)), f=f_final, num_valid=n_final)


def track_color(
    pose: jnp.ndarray,  # [4,4] world→depth-camera (pose_d)
    rgb: jnp.ndarray,  # [H, W, 3] observed rgb (0..1)
    proj_rgb: jnp.ndarray,  # rgb intrinsics (level 0)
    locations: jnp.ndarray,  # [Hs, Ws, 4] point-cloud world positions (w=±1)
    colours: jnp.ndarray,  # [Hs, Ws, 4] known colours (w=±1)
    depth_to_rgb: jnp.ndarray,  # [4,4] extrinsic (trafo_rgb_to_depth⁻¹)
    rgb_to_depth: jnp.ndarray,  # [4,4] extrinsic
    params: TrackingParams,
    skip_points: bool = True,
) -> TrackResult:
    """Photometric LM tracker with trust-region λ control (reference:
    ITMColorTracker.cpp minimizeLM:138-232 — γ₁=.75/γ₂=.25, region ×2/÷4,
    MIN_STEP 5e-5, MIN_DECREASE 1e-5, MAX_STEPS 100; pose optimized in the
    RGB frame: currentPara = calib⁻¹·M_d, TrackCamera:25-48)."""
    from infinitam_tpu.ops import color_tracking as ct
    from infinitam_tpu.ops.pyramid import build_rgb_pyramid, gradient_x, gradient_y

    MAX_STEPS = 50
    MIN_STEP = 5e-5
    MIN_DECREASE = 1e-5
    G1, G2 = 0.75, 0.25

    n_levels = params.color_n_levels
    pyr = build_rgb_pyramid(rgb, n_levels)
    grads = [(gradient_x(p), gradient_y(p)) for p in pyr]
    mask = ct.skip_points_mask(locations.shape[:2], skip_points)

    M = se3.matmul(depth_to_rgb, pose)  # pose in the rgb frame
    n_last = jnp.array(0, dtype=jnp.int32)
    f_last = jnp.array(1e5, dtype=jnp.float32)

    for lvl in range(n_levels - 1, -1, -1):
        img = pyr[lvl]
        gx, gy = grads[lvl]
        proj_l = proj_rgb * (0.5**lvl)

        def cond(s):
            M_, f_, lam_, done_, steps_ = s
            return (~done_) & (steps_ < MAX_STEPS)

        def body(s, *, img=img, gx=gx, gy=gy, proj_l=proj_l):
            M_, f_, lam_, done_, steps_ = s
            gh = ct.color_g(locations, colours, img, gx, gy, proj_l, M_, mask)
            diag = jnp.diagonal(gh.hessian)
            scaled = jnp.where(jnp.abs(diag) >= 1e-15, diag * (1.0 + lam_), lam_ * 1e-10)
            A = gh.hessian.at[jnp.arange(6), jnp.arange(6)].set(scaled)
            d = icp._solve_psd(A, gh.nabla)
            step = -d
            small = jnp.max(jnp.abs(step)) < MIN_STEP

            M2 = se3.coerce(se3.matmul(se3.se3_exp(step), M_))
            f2, _ = ct.color_f(locations, colours, img, proj_l, M2, mask)

            pred = -(
                jnp.dot(gh.nabla, step, precision=se3.HIGHEST)
                + 0.5 * jnp.dot(step, se3.matmul(gh.hessian, step), precision=se3.HIGHEST)
            )
            rho = (gh.f - f2) / jnp.where(jnp.abs(pred) < 1e-20, 1e-20, jnp.abs(pred))
            success = rho > G2
            lam_new = jnp.where(rho > G1, lam_ / 2.0, jnp.where(success, lam_, lam_ * 4.0))
            no_decrease = ~(f2 < gh.f - jnp.abs(gh.f) * MIN_DECREASE)

            M_out = jnp.where(success & ~small, M2, M_)
            f_out = jnp.where(success & ~small, f2, gh.f)
            done_out = done_ | small | (success & no_decrease)
            return (M_out, f_out, lam_new, done_out, steps_ + 1)

        init = (M, jnp.array(jnp.inf, dtype=jnp.float32), jnp.array(0.01, dtype=jnp.float32), jnp.array(False), jnp.array(0, dtype=jnp.int32))
        M, f_last, _lam, _done, _steps = jax.lax.while_loop(cond, body, init)

    new_pose = se3.coerce(se3.matmul(rgb_to_depth, M))
    _f, n_last = None, jnp.sum((locations[..., 3] > 0) & mask).astype(jnp.int32)
    return TrackResult(pose=new_pose, f=f_last, num_valid=n_last)


def track_ren(
    pose: jnp.ndarray,  # [4,4] world→camera initial estimate
    depth: jnp.ndarray,  # [H, W] metric depth
    proj: jnp.ndarray,
    read,  # voxel SDF reader closure (int pts → (sdf, found))
    voxel_size: float,
    params: TrackingParams,
    max_steps: int = 30,
) -> TrackResult:
    """Ren et al. SDF tracker — LM on the exp-SDF energy with MRP rotations
    (reference: ITMRenTracker.cpp:106-160 — λ=1000 start, ×0.1 accept / ×10
    reject, MIN_STEP 5e-5, relative MIN_DECREASE 1e-4; runs at the finest
    level as a refinement after ICP)."""
    from infinitam_tpu.ops import ren_tracking as rt

    MIN_STEP = 5e-5
    MIN_DECREASE = 1e-4

    one_over_voxel = 1.0 / voxel_size
    pts_cam = rt.unproject_view(depth, proj)
    inv_M = se3.invert(pose)

    f0 = rt.energy(read, pts_cam, inv_M, one_over_voxel)

    def cond(s):
        inv_, f_, lam_, it_, done_ = s
        return (~done_) & (it_ < max_steps)

    def body(s):
        inv_, f_, lam_, it_, done_ = s
        nabla, H = rt.gradient_hessian(read, pts_cam, inv_, one_over_voxel)
        diag = jnp.diagonal(H)
        scaled = jnp.where(jnp.abs(diag) >= 1e-15, diag * (1.0 + lam_), lam_ * 1e-10)
        A = H.at[jnp.arange(6), jnp.arange(6)].set(scaled)
        step = -icp._solve_psd(A, nabla)
        small = jnp.max(jnp.abs(step)) < MIN_STEP

        inv2 = se3.coerce(se3.matmul(rt.delta_matrix(step), inv_))
        f2 = rt.energy(read, pts_cam, inv2, one_over_voxel)
        accept = f2 < f_
        tiny = jnp.abs(f2 - f_) / jnp.maximum(jnp.abs(f_), 1e-12) < MIN_DECREASE
        lam_new = jnp.where(accept, lam_ * 0.1, lam_ * 10.0)
        inv_new = jnp.where(accept & ~small, inv2, inv_)
        f_new = jnp.where(accept & ~small, f2, f_)
        done_new = done_ | small | (accept & tiny)
        return (inv_new, f_new, lam_new, it_ + 1, done_new)

    inv_f, f_f, _l, _i, _d = jax.lax.while_loop(
        cond,
        body,
        (inv_M, f0, jnp.array(1.0, jnp.float32), jnp.array(0, jnp.int32), jnp.array(False)),
    )
    return TrackResult(
        pose=se3.invert(se3.coerce(inv_f)),
        f=f_f,
        num_valid=jnp.sum(depth > 0).astype(jnp.int32),
    )


def track_external(pose: jnp.ndarray, external_pose: jnp.ndarray) -> TrackResult:
    """External/ROS-TF pose injection — the tracker is a pass-through
    (reference: ITMExternalTracker.cpp:27-30)."""
    del pose
    return TrackResult(
        pose=external_pose,
        f=jnp.array(0.0, dtype=jnp.float32),
        num_valid=jnp.array(0, dtype=jnp.int32),
    )


def apply_imu_rotation(pose: jnp.ndarray, delta_rot: jnp.ndarray) -> jnp.ndarray:
    """Pre-rotate the pose by a differential IMU rotation before ICP
    (reference: ITMIMUTracker.cpp:17-22 — composite IMU→ICP tracker)."""
    R = se3.matmul(pose[:3, :3], delta_rot)
    return se3.coerce(se3.pack_rt(R, pose[:3, 3]))


def track_far_from_point_cloud(
    pose: jnp.ndarray, pose_point_cloud: jnp.ndarray, age: jnp.ndarray
) -> jnp.ndarray:
    """Decide whether a full raycast refresh is needed (reference:
    ITMTrackingState::TrackerFarFromPointCloud — age > 5 or camera translated
    > 0.0224 m since the last raycast)."""
    t1 = se3.invert(pose)[:3, 3]
    t2 = se3.invert(pose_point_cloud)[:3, 3]
    moved = jnp.linalg.norm(t1 - t2) > 0.02236068
    return (age > 5) | moved
