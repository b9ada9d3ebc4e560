"""Static configuration for the SLAM pipeline.

Re-expresses the reference's compile-time macros and runtime settings
(reference: ITMLib/Utils/ITMLibDefines.h:37-62, ITMLib/Utils/ITMLibSettings.{h,cpp})
as frozen dataclasses. Everything here is a jit-time constant: capacities are
static shapes, thresholds are baked into the compiled program.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple


class TrackerType(enum.Enum):
    """Camera tracker selection (reference: ITMLibSettings.h:22-37)."""

    COLOR = "color"
    ICP = "icp"
    REN = "ren"
    IMU = "imu"
    WICP = "wicp"
    EXTERNAL = "external"


class SwappingMode(enum.Enum):
    DISABLED = "disabled"
    ENABLED = "enabled"


@dataclasses.dataclass(frozen=True)
class SceneParams:
    """TSDF volume parameters (reference: ITMLib/Objects/ITMSceneParams.h,
    defaults from ITMLibSettings.cpp:10)."""

    voxel_size: float = 0.005  # metres
    mu: float = 0.02  # TSDF truncation band, metres
    max_w: int = 100  # fusion running-average weight cap
    view_frustum_min: float = 0.35  # metres
    view_frustum_max: float = 3.0  # metres
    stop_integrating_at_max_w: bool = False


@dataclasses.dataclass(frozen=True)
class VoxelBlockHashParams:
    """Sparse voxel-block-hash capacities (reference: ITMLibDefines.h:37-62).

    All capacities are static shapes. The defaults match the reference:
    2^20 ordered buckets, 2^17 excess entries, 2^16 live blocks of 8^3 voxels.
    Tests use much smaller instances.
    """

    block_size: int = 8  # voxels per block edge (SDF_BLOCK_SIZE)
    n_buckets: int = 0x100000  # ordered part of the hash table (SDF_BUCKET_NUM)
    n_excess: int = 0x20000  # excess (collision) list size (SDF_EXCESS_LIST_SIZE)
    n_blocks: int = 0x10000  # live voxel blocks on device (SDF_LOCAL_BLOCK_NUM)
    n_transfer_blocks: int = 0x1000  # swap slab size (SDF_TRANSFER_BLOCK_NUM)
    n_global_blocks: int = 0x120000  # host-side store (SDF_GLOBAL_BLOCK_NUM)
    # Visible-list capacity. The reference sizes its visibleEntryIDs buffer
    # at SDF_LOCAL_BLOCK_NUM (0x10000) because a CUDA buffer is free to
    # over-allocate; here every per-frame compaction/recheck pays the STATIC
    # capacity, so it is sized to real visibility: a 640×480 frustum sees
    # ~2 k blocks at 1 cm voxels and ~8 k at the 5 mm reference default —
    # 16 k leaves 2× headroom (overflow degrades gracefully and is counted
    # in FrameDiagnostics.n_render_overflow).
    max_visible_blocks: int = 0x4000

    @property
    def block_volume(self) -> int:
        return self.block_size**3

    @property
    def n_entries(self) -> int:
        return self.n_buckets + self.n_excess

    @property
    def hash_mask(self) -> int:
        return self.n_buckets - 1


@dataclasses.dataclass(frozen=True)
class PlainVoxelArrayParams:
    """Dense voxel volume extents (reference: ITMPlainVoxelArray.h:27-37,
    default 512^3 with offset (-256,-256,0))."""

    size: Tuple[int, int, int] = (512, 512, 512)
    offset: Tuple[int, int, int] = (-256, -256, 0)


@dataclasses.dataclass(frozen=True)
class BlockGridParams:
    """Raycast acceleration: a dense block→VBA-pointer grid cached
    over the working volume, so hot-path voxel reads cost one int gather
    instead of a hash-chain walk. Purely an accelerator — the hash table
    stays canonical (unbounded world, swapping); blocks outside the grid fall
    back to not-found, identical to unallocated space."""

    dims: Tuple[int, int, int] = (64, 64, 64)  # blocks (z, y, x order irrelevant; stored xyz)
    origin: Tuple[int, int, int] = (-32, -32, 0)  # block coords of grid corner


@dataclasses.dataclass(frozen=True)
class TrackingParams:
    """Hierarchical tracker regime (reference: ITMLibSettings.cpp:30-55,
    ITMDepthTracker.cpp:19-28)."""

    n_levels: int = 5
    # Gauss-Newton iterations per level, index 0 = finest (reference:
    # ITMDepthTracker.cpp:19-23 hardcodes 2, +2 per coarser level; here it is
    # a parameter, default equal to the reference).
    iterations_per_level: Tuple[int, ...] = (2, 4, 6, 8, 10)  # fine→coarse order
    # ICP outlier distance gate at the COARSEST level, metres² (reference:
    # ITMDepthTracker.cpp:25-28 — each finer level subtracts distThresh/n).
    dist_thresh: float = 0.1 * 0.1
    termination_threshold: float = 1e-3
    # Coarse levels optimize rotation only when True (reference:
    # ITMLibSettings.cpp:36-47 trackingRegime: both at fine levels, rotation
    # at the two coarsest of five levels).
    n_rotation_only_levels: int = 2
    # Minimum valid points for a usable system (reference:
    # ITMDepthTracker_CUDA.cu:105 gates noValidPoints>100).
    min_valid_points: int = 100
    # Divergence policy (SURVEY.md §5 failure detection — no reference
    # analogue, the reference fuses even a diverged pose): when the tracker's
    # final energy exceeds this (ops/icp.py sets f=1e5 when N≤min_valid), the
    # frame keeps the last good pose and skips fusion. <=0 disables.
    divergence_f_threshold: float = 1e4
    # Run ICP only down to this level (reference noICPRunTillLevel=0).
    no_icp_run_till_level: int = 0
    # Color tracker (reference: ITMColorTracker.cpp): LM trust region.
    color_n_levels: int = 4
    color_skip_points: bool = True


@dataclasses.dataclass(frozen=True)
class Settings:
    """Top-level runtime settings (reference: ITMLib/Utils/ITMLibSettings.h)."""

    scene: SceneParams = SceneParams()
    hashing: VoxelBlockHashParams = VoxelBlockHashParams()
    plain: PlainVoxelArrayParams = PlainVoxelArrayParams()
    block_grid: BlockGridParams = BlockGridParams()
    use_block_grid: bool = True  # raycast through the dense block-index cache
    # allocation-ray pixel stride (1 = reference-faithful every-pixel march;
    # s cuts the candidate gather/scatter cost s²× with near-identical
    # coverage). The SAFE stride depends on geometry: a block must span ≥2
    # strides at the far plane so every surface block is tapped — use
    # safe_alloc_stride() to derive it instead of guessing (a 8 cm block
    # spans ≥14 px at 3 m with f=525 → stride ≤7; 4 cm blocks → ≤3).
    alloc_subsample: int = 4
    tracking: TrackingParams = TrackingParams()
    tracker_type: TrackerType = TrackerType.ICP
    swapping_mode: SwappingMode = SwappingMode.DISABLED
    use_approximate_raycast: bool = False
    use_bilateral_filter: bool = False
    model_sensor_noise: bool = False  # fills normals + uncertainty in the view
    use_color: bool = False  # fuse RGB into the volume
    skip_points: bool = True  # subsample point cloud extraction 2x
    # Raycast expected-depth subsampling (reference minmaximg_subsample=8,
    # DeviceAgnostic/ITMVisualisationEngine.h:24).
    minmax_subsample: int = 8
    # Static cap on blocks fused per frame (XLA shapes are static; blocks
    # beyond the cap keep their values and fuse on a later frame — same
    # graceful degradation as the reference's fixed SDF_LOCAL_BLOCK_NUM).
    # 0 → process the whole visible list. Wired in
    # hash_pipeline.integrate_into_scene.
    max_fused_blocks: int = 8192
    # Static cap on visible blocks rasterized into the expected-depth minmax
    # image per frame (same graceful-degradation semantics as above).
    max_render_blocks: int = 8192
    # Static cap on NEW blocks allocated per frame (the reference's analogue
    # is the free-list supply itself; typical frames allocate a few hundred,
    # the first frame a few thousand — overflow defers to the next frame).
    max_alloc_blocks: int = 8192

    def replace(self, **kw) -> "Settings":
        return dataclasses.replace(self, **kw)


def safe_alloc_stride(settings: Settings, focal_px: float) -> int:
    """Largest allocation-ray stride that still guarantees ≥2 taps across a
    block's projected footprint at the FAR frustum plane, derived from
    voxel_size·block_size, focal length and view_frustum_max."""
    block_m = settings.scene.voxel_size * settings.hashing.block_size
    min_footprint_px = focal_px * block_m / settings.scene.view_frustum_max
    return max(1, int(min_footprint_px // 2))


def assert_alloc_stride_safe(settings: Settings, focal_px: float) -> None:
    safe = safe_alloc_stride(settings, focal_px)
    if settings.alloc_subsample > safe:
        raise ValueError(
            f"alloc_subsample={settings.alloc_subsample} exceeds the safe "
            f"stride {safe} for voxel {settings.scene.voxel_size} m × block "
            f"{settings.hashing.block_size} at f={focal_px:.0f} px, far plane "
            f"{settings.scene.view_frustum_max} m — surface blocks between "
            "allocation rays would be silently missed"
        )


def tiny_test_settings() -> Settings:
    """Small capacities for fast CPU tests. alloc_subsample stays at 2: the
    stride-4 default is budgeted for 640×480 (blocks span ≥14 px); tiny test
    images need the denser allocation sampling."""
    return Settings(
        scene=SceneParams(voxel_size=0.02, mu=0.08),
        alloc_subsample=2,
        hashing=VoxelBlockHashParams(
            n_buckets=0x1000,
            n_excess=0x200,
            n_blocks=0x800,
            n_transfer_blocks=0x100,
            n_global_blocks=0x1000,
            max_visible_blocks=0x800,
        ),
        plain=PlainVoxelArrayParams(size=(128, 128, 128), offset=(-64, -64, 0)),
    )
