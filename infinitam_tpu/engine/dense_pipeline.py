"""End-to-end per-frame pipeline on the dense voxel-array volume.

This is the plain-voxel-array configuration of the reference
(ITMVoxelIndex=ITMPlainVoxelArray, ITMLibDefines.h:211): the minimum complete
track→fuse→raycast slice. Orchestration parity:
- ITMMainEngine::ProcessFrame (ITMMainEngine.cpp:111-127)
- ITMDenseMapper::ProcessFrame (ITMDenseMapper.cpp:51-65) — plain-array branch
  has no allocation step, integration touches the whole grid
- ITMTrackingController::Track/Prepare (ITMTrackingController.cpp:11-46)

Design: one jitted `process_frame` per (settings, image size); the whole
frame — tracker LM loops included — executes on-device with no host syncs.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from infinitam_tpu.config import Settings
from infinitam_tpu.engine import volume as vol_mod
from infinitam_tpu.engine.tracking_state import TrackingState, create_tracking_state
from infinitam_tpu.engine.trackers import TrackResult, track_depth
from infinitam_tpu.engine.view_builder import View
from infinitam_tpu.engine.volume import DenseVolume
from infinitam_tpu.ops import raycast as rc
from infinitam_tpu.ops import tsdf
from infinitam_tpu.utils import se3


class FrameDiagnostics(NamedTuple):
    f: jnp.ndarray
    num_valid: jnp.ndarray


def integrate_frame_dense(
    vol: DenseVolume,
    view: View,
    pose: jnp.ndarray,
    proj_d: jnp.ndarray,
    settings: Settings,
    proj_rgb: jnp.ndarray | None = None,
    rgb_to_depth: jnp.ndarray | None = None,
) -> DenseVolume:
    """IntegrateIntoScene for the plain array: one fused pass over the grid
    (reference: ITMSceneReconstructionEngine_CPU.cpp plain-array overload)."""
    sp = settings.scene
    pts = vol_mod.voxel_world_coords(settings.plain, sp.voxel_size)
    M_rgb = None
    rgb = None
    if settings.use_color and view.rgb is not None:
        # reference: M_rgb = trafo_rgb_to_depth.calib_inv * M_d
        M_rgb = se3.matmul(se3.invert(rgb_to_depth), pose) if rgb_to_depth is not None else pose
        rgb = view.rgb
    sdf, w, clr, wc = tsdf.integrate_dense(
        vol.sdf,
        vol.w_depth,
        pts,
        pose,
        proj_d,
        view.depth,
        sp.mu,
        sp.max_w,
        stop_at_max_w=sp.stop_integrating_at_max_w,
        vol_clr=vol.clr if settings.use_color else None,
        vol_wc=vol.w_color if settings.use_color else None,
        M_rgb=M_rgb,
        proj_rgb=proj_rgb,
        rgb=rgb,
    )
    return DenseVolume(sdf=sdf, w_depth=w, clr=clr if clr is not None else vol.clr, w_color=wc if wc is not None else vol.w_color)


def raycast_dense(
    vol: DenseVolume,
    pose: jnp.ndarray,
    proj_d: jnp.ndarray,
    img_size: Tuple[int, int],
    settings: Settings,
) -> rc.RaycastResult:
    """Full-frame raycast; expected depth range is the camera frustum for the
    plain array (reference: ITMVisualisationEngine plain-array
    CreateExpectedDepths fills the whole minmax image with the frustum)."""
    sp = settings.scene
    H, W = img_size
    read = vol_mod.make_dense_reader(vol, settings.plain)
    inv_M = se3.invert(pose)
    zmin = jnp.full((H, W), sp.view_frustum_min, dtype=jnp.float32)
    zmax = jnp.full((H, W), sp.view_frustum_max, dtype=jnp.float32)
    return rc.generic_raycast(
        read,
        inv_M,
        proj_d,
        img_size,
        1.0 / sp.voxel_size,
        sp.mu,
        zmin,
        zmax,
    )


def prepare_tracking_maps(
    vol: DenseVolume,
    pose: jnp.ndarray,
    proj_d: jnp.ndarray,
    img_size: Tuple[int, int],
    settings: Settings,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """CreateICPMaps: raycast + image-space normals (reference:
    ITMVisualisationEngine CreateICPMaps → renderICP_device)."""
    res = raycast_dense(vol, pose, proj_d, img_size, settings)
    return rc.make_icp_maps(res, settings.scene.voxel_size, se3.invert(pose))


@partial(jax.jit, static_argnames=("settings", "fusion_active"))
def process_frame_dense(
    vol: DenseVolume,
    state: TrackingState,
    view: View,
    proj_d: jnp.ndarray,
    settings: Settings,
    fusion_active: bool = True,
) -> Tuple[DenseVolume, TrackingState, FrameDiagnostics]:
    """One full frame: track → integrate → raycast-prepare.

    Frame 0 (state.age == −1) skips tracking (reference:
    ITMTrackingController::Track gates on age_pointCloud == −1).
    """
    img_size = view.depth.shape

    # --- Track ---------------------------------------------------------
    tr: TrackResult = track_depth(
        state.pose,
        view.depth,
        proj_d,
        state.points_map,
        state.normals_map,
        state.pose_point_cloud,
        settings.tracking,
        weights_map=None,
    )
    have_maps = state.age >= 0
    pose = jnp.where(have_maps, tr.pose, state.pose)

    # --- Fuse ----------------------------------------------------------
    if fusion_active:
        vol = integrate_frame_dense(vol, view, pose, proj_d, settings)

    # --- Prepare (raycast for the next frame's tracker) ---------------
    points_map, normals_map = prepare_tracking_maps(vol, pose, proj_d, img_size, settings)

    new_state = TrackingState(
        pose=pose,
        points_map=points_map,
        normals_map=normals_map,
        pose_point_cloud=pose,
        age=jnp.array(0, dtype=jnp.int32),
        f=tr.f,
        num_valid=tr.num_valid,
    )
    return vol, new_state, FrameDiagnostics(f=tr.f, num_valid=tr.num_valid)


def create_engine_state(settings: Settings, img_size: Tuple[int, int]):
    """Fresh (volume, tracking state) pair (reference: ITMMainEngine ctor +
    ResetScene)."""
    vol = vol_mod.create_dense(settings.plain, with_color=settings.use_color)
    return vol, create_tracking_state(img_size)
