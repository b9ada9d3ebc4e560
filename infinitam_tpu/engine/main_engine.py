"""MainEngine façade — the reference's top-level API over the jitted pipeline.

Reference parity: ITMLib/Engine/ITMMainEngine.{h,cpp} — owns scene, tracking
state and render state; ProcessFrame = UpdateView → Track → Fuse → Prepare
(ITMMainEngine.cpp:111-127); GetImage renders depth/rgb/raycast/freeview
views (:134-192); UpdateMesh/SaveSceneToMesh; fusion on/off switches.

With swapping enabled the frame is still one jitted program
(hash_pipeline.step_frame_swap) with the host-tier exchange pipelined around
it (reference: ITMDenseMapper.cpp:51-65 runs swap-in/out between integration
and the raycast prep)."""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from infinitam_tpu.calib import RGBDCalib
from infinitam_tpu.config import Settings, SwappingMode
from infinitam_tpu.engine import hash_pipeline as hp
from infinitam_tpu.engine import hash_volume as hv
from infinitam_tpu.engine import swapping as sw
from infinitam_tpu.engine.tracking_state import create_tracking_state
from infinitam_tpu.engine.view_builder import build_view, build_view_from_metric_depth
from infinitam_tpu.ops import raycast as rc
from infinitam_tpu.utils import se3


class LazyDiag:
    """Mapping view over the device-side FrameDiagnostics pytree.

    Conversion to host scalars happens ONLY on access, so the per-frame path
    forces no device→host transfer and the host never waits on the frame it
    just dispatched. Callers that want numbers index it like a dict
    (`diag["num_valid"]`, `.get(...)`) and pay the transfer knowingly;
    `device` exposes the raw pytree for fully on-device consumers."""

    def __init__(self, d):
        self.device = d

    def _host(self, k):
        v = getattr(self.device, k)
        return float(v) if k == "f" else int(v)

    def __getitem__(self, k):
        return self._host(k)

    def get(self, k, default=None):
        if k not in self.device._fields:
            return default
        return self._host(k)

    def keys(self):
        return self.device._fields

    def as_dict(self):
        return {k: self._host(k) for k in self.device._fields}


class MainEngine:
    """Stateful façade over the functional pipeline (host-side bookkeeping,
    device-side pytrees)."""

    def __init__(self, settings: Settings, calib: RGBDCalib, img_size: Tuple[int, int]):
        self.settings = settings
        self.calib = calib
        self.img_size = img_size
        self.proj = jnp.asarray(calib.intrinsics_d.vector)
        self.proj_rgb = jnp.asarray(calib.intrinsics_rgb.vector)
        self.rgb_to_depth = jnp.asarray(calib.rgb_to_depth)

        self.vol, self.render_state, self.tracking_state = hp.create_engine_state(
            settings, img_size
        )
        self.swapping = settings.swapping_mode == SwappingMode.ENABLED
        self.swap_states = sw.create_swap_states(settings) if self.swapping else None
        self.global_cache = sw.GlobalCache.create(settings) if self.swapping else None

        self.fusion_active = True  # reference: turnOnIntegration/turnOff
        self.main_processing = True
        self.frame_no = 0
        # pipelined swap exchange (see SwapExchange): host halves of earlier
        # frames complete while this frame's device programs run
        self.swap_exchange = (
            sw.SwapExchange(settings, settings.use_color) if self.swapping else None
        )

    # ----- controls (reference: ITMMainEngine.h:95-117) ------------------
    def turn_on_integration(self):
        self.fusion_active = True

    def turn_off_integration(self):
        self.fusion_active = False

    def turn_on_main_processing(self):
        self.main_processing = True

    def turn_off_main_processing(self):
        self.main_processing = False

    def reset_scene(self):
        self.vol, self.render_state, self.tracking_state = hp.create_engine_state(
            self.settings, self.img_size
        )
        if self.swapping:
            self.swap_states = sw.create_swap_states(self.settings)
            self.global_cache = sw.GlobalCache.create(self.settings)
            self.swap_exchange = sw.SwapExchange(
                self.settings, self.settings.use_color
            )

    # ----- per frame -----------------------------------------------------
    def process_frame(
        self,
        raw_depth=None,
        rgb=None,
        metric_depth=None,
        imu_rotation=None,
        external_pose=None,
    ):
        """UpdateView → Track → Fuse (→ swap) → Prepare. Returns diagnostics
        dict (structured per-frame metrics; SURVEY.md §5 observability)."""
        if not self.main_processing:
            return {}

        if metric_depth is not None:
            view = build_view_from_metric_depth(
                jnp.asarray(metric_depth), self.settings, self.calib,
                rgb=None if rgb is None else jnp.asarray(rgb),
            )
        else:
            view = build_view(
                jnp.asarray(raw_depth), self.calib, self.settings,
                rgb=None if rgb is None else jnp.asarray(rgb),
            )

        if imu_rotation is not None:
            from infinitam_tpu.engine.trackers import apply_imu_rotation

            self.tracking_state = self.tracking_state._replace(
                pose=apply_imu_rotation(self.tracking_state.pose, jnp.asarray(imu_rotation))
            )

        if self.swapping:
            # Unified orchestration (reference: ITMDenseMapper runs the same
            # pipeline whatever the tracker): the device frame is the SAME
            # tracker-dispatch + divergence-gate + fusion as the non-swap
            # path, with the exchange's device half FUSED into the frame
            # program (step_frame_swap) and the host half pipelined a frame
            # behind on landed copies (swapping.SwapExchange) — the frame
            # never blocks on a current-frame device value.
            m_flips, m_slab = self.swap_exchange.merge_args()
            (self.vol, self.render_state, self.tracking_state,
             self.swap_states, d, in_meta, out_pack) = hp.step_frame_swap(
                self.vol,
                self.render_state,
                self.tracking_state,
                self.swap_states,
                view,
                self.proj,
                self.settings,
                self.fusion_active,
                self.proj_rgb,
                self.rgb_to_depth,
                external_pose if external_pose is not None
                else self.tracking_state.pose,
                merge_flips=m_flips,
                merge_slab=m_slab,
            )
            self.swap_exchange.after_frame(in_meta, out_pack, self.global_cache)
        else:
            (self.vol, self.render_state, self.tracking_state, d) = hp.process_frame_hash(
                self.vol,
                self.render_state,
                self.tracking_state,
                view,
                self.proj,
                self.settings,
                fusion_active=self.fusion_active,
                proj_rgb=self.proj_rgb,
                rgb_to_depth=self.rgb_to_depth,
                external_pose=external_pose,
            )
        self.frame_no += 1
        # device-side pytree wrapped for lazy host access — the frame path
        # itself performs NO device→host transfer
        return LazyDiag(d)

    def flush_swap(self):
        """Drain the pipelined swap exchange (checkpoint save, shutdown):
        complete the pending host halves and merges, then run one FULL-scan
        eviction (the per-frame path scans a rotating window) so the volume
        + global cache reflect every processed frame."""
        if not self.swapping:
            return
        self.vol, self.swap_states = self.swap_exchange.flush(
            self.vol, self.swap_states, self.global_cache
        )
        self.vol, self.swap_states = sw.swap_out(
            self.vol, self.swap_states, self.render_state,
            self.global_cache, self.settings,
        )

    # ----- outputs (reference: GetImage, UpdateMesh) ---------------------
    def get_pose(self) -> np.ndarray:
        return np.asarray(self.tracking_state.pose)

    def set_pose(self, pose) -> None:
        """External pose injection (reference: RosPoseSourceEngine writes
        trackingState->pose_d directly)."""
        self.tracking_state = self.tracking_state._replace(pose=jnp.asarray(pose))

    def get_image(self, which: str = "raycast", pose=None, proj=None, view=None) -> np.ndarray:
        """Render a view (reference GetImage types, ITMMainEngine.cpp:134-192):
        'raycast' (grey shaded from the current pose), 'normals', 'colour',
        'depth' (rainbow colormap of the raycast depth — the reference's
        ORIGINAL_DEPTH type when given `view`, else scene depth), 'weight'
        (fusion-confidence colormap), or freeview variants by passing an
        explicit pose."""
        from infinitam_tpu.ops import colormaps as cm

        freeview = pose is not None
        pose = self.tracking_state.pose if pose is None else jnp.asarray(pose)
        proj = self.proj if proj is None else jnp.asarray(proj)
        if which == "depth" and view is not None:
            # reference InfiniTAM_IMAGE_ORIGINAL_DEPTH: colormap the input
            return np.asarray(cm.depth_to_uchar4(jnp.asarray(view)))
        # Freeview renders rebuild a visible list for the REQUESTED pose
        # (reference: GetImage runs FindVisibleBlocks → CreateExpectedDepths
        # on a dedicated renderState_freeview, ITMMainEngine.cpp:176-182);
        # the live list only covers the tracked camera's frustum.
        rs = (
            hp.find_visible_blocks(self.vol, pose, proj, self.img_size, self.settings)
            if freeview
            else self.render_state
        )
        res = hp.raycast_hash(
            self.vol, rs, pose, proj, self.img_size, self.settings
        )
        inv = se3.invert(pose)
        if which == "normals":
            return np.asarray(rc.render_normals(res, self.settings.scene.voxel_size, inv))
        if which == "colour":
            reader = hv.make_hash_color_reader(self.vol, self.settings.hashing)
            return np.asarray(rc.render_color(res, reader))
        if which == "depth":
            # z-depth of the raycast surface in the camera frame
            found = res.points[..., 3] > 0
            pw = res.points[..., :3] * self.settings.scene.voxel_size
            z = se3.apply(pose, pw)[..., 2]
            return np.asarray(cm.depth_to_uchar4(jnp.where(found, z, -1.0)))
        if which == "weight":
            # fusion weight at the raycast surface (reference WeightToUchar4)
            from infinitam_tpu.ops.voxel_access import read_sdf_uninterpolated

            if self.settings.use_block_grid:
                grid = hv.get_block_grid(self.vol, self.settings.block_grid, self.settings.hashing)
                read_w = hv.make_grid_weight_reader(self.vol, grid, self.settings.block_grid, self.settings.hashing)
            else:
                read_w = hv.make_hash_weight_reader(self.vol, self.settings.hashing)
            ipts = jnp.floor(res.points[..., :3] + 0.5).astype(jnp.int32)
            w, _ = read_w(ipts)
            found = res.points[..., 3] > 0
            return np.asarray(cm.weight_to_uchar4(jnp.where(found, w, 0.0)))
        return np.asarray(rc.render_grey(res, self.settings.scene.voxel_size, inv))

    def update_mesh(self):
        from infinitam_tpu.engine.meshing_engine import mesh_scene_hash

        return mesh_scene_hash(self.vol, self.settings)

    def save_scene_to_mesh(self, path: str) -> None:
        mesh = self.update_mesh()
        if path.lower().endswith(".obj"):
            mesh.write_obj(path)
        else:
            mesh.write_stl(path)
