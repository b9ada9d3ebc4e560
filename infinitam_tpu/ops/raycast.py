"""Raycasting: sphere-traced TSDF surface extraction + ICP map synthesis.

Plain-XLA design: instead of one divergent while-loop per CUDA thread
(reference: DeviceAgnostic/ITMVisualisationEngine.h:92-158 castRay), the whole
image marches in lock-step inside `lax` loops whose state is the full [H, W]
ray front; finished rays are masked out. This is the reference path and the
CPU path; on a GPU the hash pipeline marches the same rays with the Triton
kernel of ops/raycast_kernel.py, one program per tile of rays.

Map synthesis (points/normals/shading) reference:
DeviceAgnostic/ITMVisualisationEngine.h:160-409 (computeNormalAndAngle image-
space variant, processPixelICP, drawPixelGrey/Normal/Colour).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from infinitam_tpu.ops.voxel_access import (
    ReadFn,
    read_color_interpolated,
    read_sdf_interpolated,
    read_sdf_uninterpolated,
)
from infinitam_tpu.utils import se3


class RaycastResult(NamedTuple):
    # [H, W, 4]: xyz = hit position in *voxel units* (world grid frame),
    # w = 1.0 found / 0.0 miss (reference: raycastResult image semantics).
    points: jnp.ndarray
    # visible blocks left out of the expected-depth ranges as too large to
    # rasterize (hash volume only; see hash_pipeline.expected_depth_ranges)
    n_too_big_blocks: jnp.ndarray | None = None


def pixel_rays(
    inv_M: jnp.ndarray,
    proj: jnp.ndarray,
    img_size: Tuple[int, int],
    one_over_voxel_size: float,
    zmin: jnp.ndarray,
    zmax: jnp.ndarray,
):
    """Per-pixel ray parameters in voxel units: (pt_start [H,W,3], ray_dir,
    len_start [H,W], len_end)."""
    H, W = img_size
    fx, fy, cx, cy = proj[0], proj[1], proj[2], proj[3]
    xs = jnp.arange(W, dtype=jnp.float32)[None, :].repeat(H, axis=0)
    ys = jnp.arange(H, dtype=jnp.float32)[:, None].repeat(W, axis=1)
    dir_cam = jnp.stack([(xs - cx) / fx, (ys - cy) / fy, jnp.ones_like(xs)], axis=-1)

    def to_world_voxels(z):
        pc = dir_cam * z[..., None]
        pw = se3.apply(inv_M, pc)
        return pw * one_over_voxel_size

    pt_start = to_world_voxels(zmin)
    pt_end = to_world_voxels(zmax)
    len_start = jnp.linalg.norm(dir_cam * zmin[..., None], axis=-1) * one_over_voxel_size
    len_end = jnp.linalg.norm(dir_cam * zmax[..., None], axis=-1) * one_over_voxel_size
    ray_dir = pt_end - pt_start
    ray_dir = ray_dir / jnp.maximum(jnp.linalg.norm(ray_dir, axis=-1, keepdims=True), 1e-12)
    return pt_start, ray_dir, len_start, len_end


def raycast_rays(
    read: ReadFn,
    pt_start: jnp.ndarray,  # [..., 3] voxel units
    ray_dir: jnp.ndarray,  # [..., 3] unit
    len_start: jnp.ndarray,  # [...]
    len_end: jnp.ndarray,  # [...]
    step_scale: float,  # mu / voxel_size
    block_size: int = 8,
    active_init: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Lock-step sphere tracing along arbitrary ray bundles → [..., 4]
    (position in voxel units, w = hit flag).

    Semantics follow the reference castRay: step sdf·(mu/voxelSize) clamped
    to ≥1 voxel inside allocated space; stop on sign change; trilinear secant
    refinement. Differences (deliberate):
    - the march reads UNINTERPOLATED only (the reference also trilinearly
      re-reads inside the −0.5..0.1 band every step, castRay:135-138 — in a
      lock-step march both predicated branches execute, 9 probes/step);
    - through unallocated space the step is a DDA clamp to the current
      block's exit instead of the blind 8-voxel jump (castRay:131), which
      can clear the whole ±mu shell and lose the ray — a known InfiniTAM
      hole artifact.
    """
    shape = len_start.shape

    class _S(NamedTuple):
        pt: jnp.ndarray
        total: jnp.ndarray
        sdf: jnp.ndarray
        active: jnp.ndarray

    def body(s: _S, ray_dir, len_end):
        sdf, found = read_sdf_uninterpolated(read, s.pt)
        hit = found & (sdf <= 0.0)
        blk = jnp.floor(s.pt / block_size)
        nxt_bound = (blk + (ray_dir > 0)) * block_size
        safe_dir = jnp.where(jnp.abs(ray_dir) < 1e-9, 1e-9, ray_dir)
        t_axis = (nxt_bound - s.pt) / safe_dir
        t_exit = jnp.min(jnp.where(jnp.abs(ray_dir) < 1e-9, 1e9, t_axis), axis=-1)
        empty_step = jnp.clip(t_exit + 0.01, 0.5, float(block_size))
        step = jnp.where(found, jnp.maximum(sdf * step_scale, 1.0), empty_step)

        advance = s.active & ~hit
        new_pt = jnp.where(advance[..., None], s.pt + step[..., None] * ray_dir, s.pt)
        new_total = jnp.where(advance, s.total + step, s.total)
        new_active = advance & (new_total < len_end)
        new_sdf = jnp.where(s.active, sdf, s.sdf)
        return _S(pt=new_pt, total=new_total, sdf=new_sdf, active=new_active)

    init = _S(
        pt=pt_start,
        total=len_start,
        sdf=jnp.ones(shape, dtype=jnp.float32),
        active=jnp.ones(shape, dtype=bool) if active_init is None else active_init,
    )

    # Two-phase march (the CUDA reference lets each thread exit early, but a
    # lock-step march pays EVERY ray's cost until the slowest straggler
    # finishes). Phase 1: a fixed-count march over the full bundle. Phase 2:
    # compact the surviving stragglers into a small dense bundle and march
    # those to completion, then scatter back.
    PHASE1 = 20
    final = jax.lax.fori_loop(
        0, PHASE1, lambda _i, s: body(s, ray_dir, len_end), init
    )

    n = 1
    for d in shape:
        n *= d
    if n >= 4096:  # compaction only pays off for large bundles
        cap = n // 4
        flat = lambda a: a.reshape((n,) + a.shape[len(shape):])

        def compacted_finish(st: _S) -> _S:
            f_active = flat(st.active)
            idx = jnp.nonzero(f_active, size=cap, fill_value=-1)[0]
            sel = jnp.clip(idx, 0, n - 1)
            sub = _S(
                pt=flat(st.pt)[sel],
                total=flat(st.total)[sel],
                sdf=flat(st.sdf)[sel],
                active=f_active[sel] & (idx >= 0),
            )
            sub_dir = flat(ray_dir)[sel]
            sub_end = flat(len_end)[sel]
            sub_final = jax.lax.while_loop(
                lambda s: jnp.any(s.active),
                lambda s: body(s, sub_dir, sub_end),
                sub,
            )
            scatter_to = jnp.where(idx >= 0, sel, n)
            f_pt = flat(st.pt).at[scatter_to].set(sub_final.pt, mode="drop")
            f_total = flat(st.total).at[scatter_to].set(sub_final.total, mode="drop")
            f_sdf = flat(st.sdf).at[scatter_to].set(sub_final.sdf, mode="drop")
            return _S(
                pt=f_pt.reshape(shape + (3,)),
                total=f_total.reshape(shape),
                sdf=f_sdf.reshape(shape),
                active=jnp.zeros(shape, dtype=bool),
            )

        def full_finish(st: _S) -> _S:
            out = jax.lax.while_loop(
                lambda s: jnp.any(s.active), lambda s: body(s, ray_dir, len_end), st
            )
            return out._replace(active=jnp.zeros(shape, dtype=bool))

        n_active = jnp.sum(final.active)
        final = jax.lax.cond(n_active <= cap, compacted_finish, full_finish, final)
    else:
        final = jax.lax.while_loop(
            lambda s: jnp.any(s.active), lambda s: body(s, ray_dir, len_end), final
        )

    found_surface = (final.sdf <= 0.0) & (
        jnp.ones(shape, dtype=bool) if active_init is None else active_init
    )
    pt = final.pt + (final.sdf * step_scale)[..., None] * ray_dir
    sdf_refined, _ = read_sdf_interpolated(read, pt)
    pt = pt + (sdf_refined * step_scale)[..., None] * ray_dir
    sdf_refined2, _ = read_sdf_interpolated(read, pt)
    pt = pt + (sdf_refined2 * step_scale)[..., None] * ray_dir

    return jnp.concatenate(
        [
            jnp.where(found_surface[..., None], pt, final.pt),
            jnp.where(found_surface, 1.0, 0.0)[..., None],
        ],
        axis=-1,
    )


def generic_raycast(
    read: ReadFn,
    inv_M: jnp.ndarray,  # [4,4] camera→world
    proj: jnp.ndarray,  # (fx, fy, cx, cy)
    img_size: Tuple[int, int],  # (H, W)
    one_over_voxel_size: float,
    mu: float,
    zmin: jnp.ndarray,  # [H, W] per-pixel near range (metres)
    zmax: jnp.ndarray,  # [H, W] far range (metres)
    block_size: int = 8,
    max_steps: int | None = None,
) -> RaycastResult:
    """Full-image raycast (reference: genericRaycast_device over all pixels)."""
    del max_steps
    pt_start, ray_dir, len_start, len_end = pixel_rays(
        inv_M, proj, img_size, one_over_voxel_size, zmin, zmax
    )
    points = raycast_rays(
        read, pt_start, ray_dir, len_start, len_end, mu * one_over_voxel_size, block_size
    )
    return RaycastResult(points=points)


def _normals_planes(
    px: jnp.ndarray,  # [H,W] raycast point components, voxel units
    py: jnp.ndarray,
    pz: jnp.ndarray,
    found: jnp.ndarray,  # [H,W] bool
    voxel_size: float,
    light_source: jnp.ndarray,  # [3]
    use_smoothing: bool = True,
):
    """Core of compute_normals_image_space on component planes — every op
    is a full-[H,W] elementwise pass. Returns (nx, ny, nz, angle, valid)."""
    H, W = px.shape

    def sh(a, dy, dx):
        return jnp.roll(a, shift=(-dy, -dx), axis=(0, 1))

    def diffs(d):
        ok = sh(found, 0, d) & sh(found, 0, -d) & sh(found, d, 0) & sh(found, -d, 0)
        dxx = sh(px, 0, d) - sh(px, 0, -d)
        dxy = sh(py, 0, d) - sh(py, 0, -d)
        dxz = sh(pz, 0, d) - sh(pz, 0, -d)
        dyx = sh(px, d, 0) - sh(px, -d, 0)
        dyy = sh(py, d, 0) - sh(py, -d, 0)
        dyz = sh(pz, d, 0) - sh(pz, -d, 0)
        return (dxx, dxy, dxz), (dyx, dyy, dyz), ok

    if use_smoothing:
        (dxx2, dxy2, dxz2), (dyx2, dyy2, dyz2), ok2 = diffs(2)
        len_diff = jnp.maximum(
            dxx2 * dxx2 + dxy2 * dxy2 + dxz2 * dxz2,
            dyx2 * dyx2 + dyy2 * dyy2 + dyz2 * dyz2,
        )
        jump = len_diff * voxel_size * voxel_size > 0.15 * 0.15
        (dxx1, dxy1, dxz1), (dyx1, dyy1, dyz1), ok1 = diffs(1)
        use1 = ~ok2 | jump
        dxx = jnp.where(use1, dxx1, dxx2)
        dxy = jnp.where(use1, dxy1, dxy2)
        dxz = jnp.where(use1, dxz1, dxz2)
        dyx = jnp.where(use1, dyx1, dyx2)
        dyy = jnp.where(use1, dyy1, dyy2)
        dyz = jnp.where(use1, dyz1, dyz2)
        ok = jnp.where(use1, ok1, ok2)
        border = 3
    else:
        (dxx, dxy, dxz), (dyx, dyy, dyz), ok = diffs(1)
        border = 2

    # n = −(diff_x × diff_y), component-wise
    nx = -(dxy * dyz - dxz * dyy)
    ny = -(dxz * dyx - dxx * dyz)
    nz = -(dxx * dyy - dxy * dyx)
    norm = jnp.sqrt(nx * nx + ny * ny + nz * nz)
    inv = 1.0 / jnp.maximum(norm, 1e-12)
    nx = nx * inv
    ny = ny * inv
    nz = nz * inv
    angle = nx * light_source[0] + ny * light_source[1] + nz * light_source[2]

    xs = jnp.arange(W)[None, :]
    ys = jnp.arange(H)[:, None]
    in_border = (xs > border - 1) & (xs < W - border) & (ys > border - 1) & (ys < H - border)
    valid = found & ok & (angle > 0) & in_border & (norm > 0)
    return nx, ny, nz, angle, valid


def compute_normals_image_space(
    points_ray: jnp.ndarray,  # [H,W,4] raycast result, voxel units
    voxel_size: float,
    light_source: jnp.ndarray,  # [3]
    use_smoothing: bool = True,
):
    """Normals from neighbouring raycast points, with the reference's ±2px
    smoothing and ±1px fallback on large jumps (reference:
    computeNormalAndAngle<useSmoothing>, ITMVisualisationEngine.h:191-255).

    Returns (normals [H,W,3], angle [H,W], valid [H,W])."""
    nx, ny, nz, angle, valid = _normals_planes(
        points_ray[..., 0], points_ray[..., 1], points_ray[..., 2],
        points_ray[..., 3] > 0, voxel_size, light_source, use_smoothing,
    )
    return jnp.stack([nx, ny, nz], axis=-1), angle, valid


def make_icp_maps(
    raycast: RaycastResult,
    voxel_size: float,
    inv_M: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Build the tracker's target maps from a raycast (reference:
    renderICP_device / processPixelICP): points in metres (w=1 valid) and
    world-frame unit normals (w=1 valid); invalid pixels get w=-1.

    All internal math runs on component planes; the [H,W,4] maps are
    assembled by ONE stack each at the end."""
    light_source = -inv_M[:3, 2] / jnp.linalg.norm(inv_M[:3, 2])
    px = raycast.points[..., 0]
    py = raycast.points[..., 1]
    pz = raycast.points[..., 2]
    found = raycast.points[..., 3] > 0
    nx, ny, nz, _angle, valid = _normals_planes(
        px, py, pz, found, voxel_size, light_source, use_smoothing=True
    )
    w = jnp.where(valid, 1.0, -1.0)
    z = jnp.zeros_like(px)
    points_map = jnp.stack(
        [
            jnp.where(valid, px * voxel_size, z),
            jnp.where(valid, py * voxel_size, z),
            jnp.where(valid, pz * voxel_size, z),
            w,
        ],
        axis=-1,
    )
    normals_map = jnp.stack(
        [
            jnp.where(valid, nx, z),
            jnp.where(valid, ny, z),
            jnp.where(valid, nz, z),
            w,
        ],
        axis=-1,
    )
    return points_map, normals_map


def render_grey(raycast: RaycastResult, voxel_size: float, inv_M: jnp.ndarray) -> jnp.ndarray:
    """Grey-shaded rendering (reference: drawPixelGrey: 0.8·angle+0.2)."""
    light_source = -inv_M[:3, 2] / jnp.linalg.norm(inv_M[:3, 2])
    _n, angle, valid = compute_normals_image_space(
        raycast.points, voxel_size, light_source, use_smoothing=False
    )
    shade = jnp.where(valid, 0.8 * angle + 0.2, 0.0)
    return (jnp.clip(shade, 0.0, 1.0) * 255.0).astype(jnp.uint8)


def render_normals(raycast: RaycastResult, voxel_size: float, inv_M: jnp.ndarray) -> jnp.ndarray:
    """False-colour normals (reference: drawPixelNormal)."""
    light_source = -inv_M[:3, 2] / jnp.linalg.norm(inv_M[:3, 2])
    n, _angle, valid = compute_normals_image_space(
        raycast.points, voxel_size, light_source, use_smoothing=False
    )
    img = (0.3 + (-n + 1.0) * 0.35) * 255.0
    img = jnp.where(valid[..., None], img, 0.0)
    return jnp.clip(img, 0, 255).astype(jnp.uint8)


def render_color(raycast: RaycastResult, read_color) -> jnp.ndarray:
    """Volume-colour rendering (reference: drawPixelColour)."""
    rgb = read_color_interpolated(read_color, raycast.points[..., :3])
    valid = raycast.points[..., 3] > 0
    img = jnp.where(valid[..., None], rgb * 255.0, 0.0)
    return jnp.clip(img, 0, 255).astype(jnp.uint8)


def forward_render(
    read: ReadFn,
    prev_points_map_m: jnp.ndarray,  # [H,W,4] previous raycast, metres, w>0 valid
    M: jnp.ndarray,  # world→camera, NEW pose
    proj: jnp.ndarray,
    img_size: Tuple[int, int],
    one_over_voxel_size: float,
    mu: float,
    zmin: jnp.ndarray,
    zmax: jnp.ndarray,
    block_size: int = 8,
    missing_cap_fraction: int = 4,
) -> RaycastResult:
    """Incremental raycast (reference: ForwardRender_common,
    ITMVisualisationEngine_CUDA.cu:314-380): scatter the previous raycast
    into the new view, then raycast ONLY the missing pixels.

    The missing set is compacted with nonzero(size=H·W/cap) into
    a dense ray bundle (the analogue of findMissingPoints_device's prefix-sum
    compaction) so the march costs a fraction of a full raycast; overflow
    pixels beyond the cap stay holes until the next full raycast.
    """
    H, W = img_size
    fwd = forward_project(prev_points_map_m, M, proj, img_size, one_over_voxel_size)

    # missing: not forward-projected but the expected-depth range is non-empty
    # (reference: findMissingPoints_device checks minmaximg x < y)
    missing = (fwd[..., 3] <= 0) & (zmax > zmin)
    cap = (H * W) // missing_cap_fraction
    idx = jnp.nonzero(missing.reshape(-1), size=cap, fill_value=-1)[0]
    valid = idx >= 0
    idx_c = jnp.clip(idx, 0, H * W - 1)

    inv_M = se3.invert(M)
    pt_start, ray_dir, len_start, len_end = pixel_rays(
        inv_M, proj, img_size, one_over_voxel_size, zmin, zmax
    )
    flat = lambda a: a.reshape(-1, a.shape[-1]) if a.ndim == 3 else a.reshape(-1)
    pts = raycast_rays(
        read,
        flat(pt_start)[idx_c],
        flat(ray_dir)[idx_c],
        flat(len_start)[idx_c],
        flat(len_end)[idx_c],
        mu * one_over_voxel_size,
        block_size,
        active_init=valid,
    )
    out = fwd.reshape(-1, 4)
    out = out.at[jnp.where(valid, idx_c, H * W)].set(pts, mode="drop")
    return RaycastResult(points=out.reshape(H, W, 4))


def forward_project(
    points_map_m: jnp.ndarray,  # [H,W,4] metres, w>0 valid (prev raycast * voxelSize)
    M: jnp.ndarray,  # world→camera of the NEW pose
    proj: jnp.ndarray,
    img_size: Tuple[int, int],
    one_over_voxel_size: float,
) -> jnp.ndarray:
    """Scatter the previous raycast into the new view (reference:
    forwardProjectPixel + forwardProject_device). Returns [H,W,4] voxel-unit
    points with w=1 where projected, 0 where missing."""
    H, W = img_size
    fx, fy, cx, cy = proj[0], proj[1], proj[2], proj[3]
    valid = points_map_m[..., 3] > 0
    pc = se3.apply(M, points_map_m[..., :3])
    z = jnp.where(pc[..., 2] <= 0, 1.0, pc[..., 2])
    u = fx * pc[..., 0] / z + cx
    v = fy * pc[..., 1] / z + cy
    ok = valid & (pc[..., 2] > 0) & (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    ui = jnp.clip((u + 0.5).astype(jnp.int32), 0, W - 1)
    vi = jnp.clip((v + 0.5).astype(jnp.int32), 0, H - 1)

    out = jnp.zeros((H, W, 4), dtype=jnp.float32)
    pts_voxel = points_map_m[..., :3] * one_over_voxel_size
    payload = jnp.concatenate([pts_voxel, jnp.ones_like(z)[..., None]], axis=-1)
    flat_idx = jnp.where(ok, vi * W + ui, H * W)  # out-of-range drops
    out = out.reshape(-1, 4).at[flat_idx.reshape(-1)].set(
        payload.reshape(-1, 4), mode="drop"
    )
    return out.reshape(H, W, 4)
