"""The XLA hash-volume integrate (hash_pipeline.integrate_into_scene: row
gather → fused TSDF update → row scatter) against an independent per-voxel
NumPy TSDF update (reference: DeviceAgnostic/ITMSceneReconstructionEngine.h
computeUpdatedVoxelDepthInfo / computeUpdatedVoxelColorInfo).

The NumPy side works in float32 like the device, so the two agree to one
quantization step except where a gate sits on a rounding boundary.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from infinitam_tpu.calib import default_calib
from infinitam_tpu.config import (
    BlockGridParams,
    SceneParams,
    Settings,
    TrackingParams,
    VoxelBlockHashParams,
)
from infinitam_tpu.engine import hash_pipeline as hp
from infinitam_tpu.engine.view_builder import View
from infinitam_tpu.io import synth

IMG = (64, 64)
F32 = np.float32


def make_settings(**scene_kw) -> Settings:
    return Settings(
        scene=SceneParams(
            voxel_size=0.025, mu=0.1, view_frustum_min=0.3, view_frustum_max=3.0,
            **scene_kw,
        ),
        hashing=VoxelBlockHashParams(
            n_buckets=0x4000, n_excess=0x400, n_blocks=0x1800, max_visible_blocks=0x1000,
        ),
        block_grid=BlockGridParams(dims=(32, 32, 32), origin=(-16, -16, 0)),
        tracking=TrackingParams(n_levels=3, min_valid_points=50),
        max_fused_blocks=1024,
        max_render_blocks=512,
    )


def fused_scene(settings, with_rgb=False):
    calib = default_calib(IMG[1], IMG[0])
    proj = jnp.asarray(calib.intrinsics_d.vector)
    src = synth.SyntheticSource(calib, n_frames=2, img_size=IMG, with_rgb=with_rgb)
    depth, rgb, _gt = src.get_images()
    kw = dict(proj_rgb=proj, rgb_to_depth=jnp.eye(4)) if with_rgb else {}
    vol, rs, state = hp.create_engine_state(settings, IMG)
    for _ in range(2):
        vol, rs, state, _diag = hp.process_frame_hash(
            vol, rs, state, View(depth=depth, rgb=rgb), proj, settings, **kw
        )
    return View(depth=depth, rgb=rgb), proj, vol, rs, state.pose


def _unpack(vox):
    vox = np.asarray(vox).astype(np.int64)
    return (vox >> 16).astype(F32) / F32(32767.0), (vox >> 8) & 0xFF


def numpy_integrate(vol, rs, view, pose, proj, settings):
    """Per-voxel TSDF (+ colour) update of every visible block, in NumPy
    (vectorized over the voxels). Returns (sdf_q, w, rgb_q, wc) planes of the
    whole block array."""
    sp, hpar = settings.scene, settings.hashing
    S = hpar.block_size
    sdf_all, w_all = _unpack(vol.vox)
    sdf_all, w_all = sdf_all.copy(), w_all.copy()
    with_color = vol.vox_rgb is not None
    if with_color:
        rgbq = np.asarray(vol.vox_rgb).astype(np.int64) & 0xFFFFFFFF
        clr_all = np.stack([(rgbq >> s) & 0xFF for s in (24, 16, 8)], -1).astype(F32)
        wc_all = (rgbq & 0xFF).copy()
        rgb_img = np.asarray(view.rgb, F32)
    depth = np.asarray(view.depth, F32)
    H, W = depth.shape
    fx, fy, cx, cy = (F32(v) for v in np.asarray(proj))
    M = np.asarray(pose, F32)
    ids = np.asarray(rs.visible_ids)[: settings.max_fused_blocks]
    ptr_all = np.asarray(vol.entry_ptr)
    pos_all = np.asarray(vol.entry_pos)
    lin = np.arange(S**3)
    local = np.stack([lin % S, (lin // S) % S, lin // (S * S)], -1)
    mu, max_w = F32(sp.mu), sp.max_w
    e = ids[ids >= 0]
    e = e[ptr_all[e] >= 0]
    ptr = ptr_all[e]  # [V] rows of the visible blocks, one voxel per column
    p = ((pos_all[e][:, None, :] * S + local[None]).astype(F32)) * F32(sp.voxel_size)
    pc = np.einsum("ij,vkj->vki", M[:3, :3], p) + M[:3, 3]
    z = pc[..., 2]
    ok = z > 0
    zs = np.where(ok, z, F32(1.0))
    u = fx * pc[..., 0] / zs + cx
    vv = fy * pc[..., 1] / zs + cy
    ok &= (u >= 1) & (u <= W - 2) & (vv >= 1) & (vv <= H - 2)
    ui = np.clip((u + F32(0.5)).astype(np.int64), 0, W - 1)
    vi = np.clip((vv + F32(0.5)).astype(np.int64), 0, H - 1)
    d = depth[vi, ui]
    ok &= d > 0
    eta = d - z
    upd = ok & (eta >= -mu)
    old_f, old_w = sdf_all[ptr], w_all[ptr]
    if sp.stop_integrating_at_max_w:
        upd &= old_w < max_w
    new_f = (old_w * old_f + np.minimum(F32(1.0), eta / mu)) / (old_w + 1).astype(F32)
    sdf_all[ptr] = np.where(upd, new_f, old_f)
    w_all[ptr] = np.where(upd, np.minimum(old_w + 1, max_w), old_w)
    if with_color:
        cgate = upd & ~((eta > mu) | (np.abs(eta / mu) > 0.25))
        x0 = np.clip(np.floor(u).astype(np.int64), 0, W - 2)
        y0 = np.clip(np.floor(vv).astype(np.int64), 0, H - 2)
        ax, ay = (u - x0)[..., None], (vv - y0)[..., None]
        c = (
            rgb_img[y0, x0] * (1 - ax) * (1 - ay) + rgb_img[y0, x0 + 1] * ax * (1 - ay)
            + rgb_img[y0 + 1, x0] * (1 - ax) * ay + rgb_img[y0 + 1, x0 + 1] * ax * ay
        )
        wc = wc_all[ptr]
        old_c = clr_all[ptr] / F32(255.0)
        new_c = (old_c * wc[..., None] + c) / (wc + 1)[..., None].astype(F32)
        clr_all[ptr] = np.where(
            cgate[..., None], np.round(np.clip(new_c, 0, 1) * 255.0), clr_all[ptr]
        )
        wc_all[ptr] = np.where(cgate, np.minimum(wc + 1, max_w), wc)
    q = np.round(np.clip(sdf_all, -1, 1) * 32767.0)
    if with_color:
        return q, w_all, clr_all, wc_all
    return q, w_all, None, None


def _compare(out, vol_before, ref_q, ref_w, min_changed=1000):
    q, w = _unpack(out.vox)
    q = np.round(q * 32767.0)
    changed = (np.asarray(out.vox) != np.asarray(vol_before.vox)).sum()
    assert changed >= min_changed, f"only {changed} voxels updated"
    # weights equal, sdf within one quantization step, except on rounding
    # boundaries of the projection / truncation gates
    assert (w == ref_w).mean() > 0.9995, f"weights differ at {(w != ref_w).sum()} voxels"
    assert (np.abs(q - ref_q) <= 1).mean() > 0.9995


def test_depth_integrate_matches_numpy():
    settings = make_settings()
    view, proj, vol, rs, pose = fused_scene(settings)
    out = hp.integrate_into_scene(vol, rs, view, pose, proj, settings)
    ref_q, ref_w, _, _ = numpy_integrate(vol, rs, view, pose, proj, settings)
    _compare(out, vol, ref_q, ref_w)


def test_color_integrate_matches_numpy():
    settings = make_settings().replace(use_color=True)
    view, proj, vol, rs, pose = fused_scene(settings, with_rgb=True)
    out = hp.integrate_into_scene(
        vol, rs, view, pose, proj, settings, proj_rgb=proj, rgb_to_depth=jnp.eye(4)
    )
    ref_q, ref_w, ref_c, ref_wc = numpy_integrate(vol, rs, view, pose, proj, settings)
    _compare(out, vol, ref_q, ref_w)
    rgbq = np.asarray(out.vox_rgb).astype(np.int64) & 0xFFFFFFFF
    clr = np.stack([(rgbq >> s) & 0xFF for s in (24, 16, 8)], -1)
    assert (rgbq & 0xFF == ref_wc).mean() > 0.9995
    assert (np.abs(clr - ref_c) <= 1).all(axis=-1).mean() > 0.9995
    assert (ref_wc > np.asarray(vol.vox_rgb) & 0xFF).sum() > 100  # colour really fused


def test_integrate_enable_false_is_noop():
    settings = make_settings()
    view, proj, vol, rs, pose = fused_scene(settings)
    out = hp.integrate_into_scene(vol, rs, view, pose, proj, settings, enable=jnp.array(False))
    np.testing.assert_array_equal(np.asarray(out.vox), np.asarray(vol.vox))


@pytest.mark.parametrize("max_w", [1, 2])
def test_stop_integrating_at_max_w(max_w):
    """Voxels already at max_w stay frozen (reference
    stopIntegratingAtMaxW); the rest still fuse."""
    settings = make_settings()
    settings = dataclasses.replace(
        settings,
        scene=dataclasses.replace(settings.scene, max_w=max_w, stop_integrating_at_max_w=True),
    )
    view, proj, vol, rs, pose = fused_scene(settings)
    out = hp.integrate_into_scene(vol, rs, view, pose, proj, settings)
    ref_q, ref_w, _, _ = numpy_integrate(vol, rs, view, pose, proj, settings)
    _compare(out, vol, ref_q, ref_w, min_changed=0)
    _q, w_before = _unpack(vol.vox)
    at_cap = w_before >= max_w
    assert at_cap.sum() > 100
    np.testing.assert_array_equal(np.asarray(out.vox)[at_cap], np.asarray(vol.vox)[at_cap])
