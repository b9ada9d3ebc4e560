"""End-to-end tests on the voxel-block-hash pipeline (reference default
configuration), against the synthetic analytic-SDF oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from infinitam_tpu.calib import default_calib
from infinitam_tpu.config import (
    SceneParams,
    Settings,
    TrackingParams,
    VoxelBlockHashParams,
)
from infinitam_tpu.engine import hash_pipeline as hp
from infinitam_tpu.engine import hash_volume as hv
from infinitam_tpu.engine.view_builder import View
from infinitam_tpu.io import synth
from infinitam_tpu.utils import se3

IMG = (60, 80)


def hash_settings() -> Settings:
    return Settings(
        scene=SceneParams(voxel_size=0.025, mu=0.1, view_frustum_min=0.3, view_frustum_max=3.0),
        hashing=VoxelBlockHashParams(
            n_buckets=0x4000,
            n_excess=0x400,
            n_blocks=0x1800,
            max_visible_blocks=0x1000,
        ),
        tracking=TrackingParams(n_levels=3, min_valid_points=50),
    )


SETTINGS = hash_settings()
CALIB = default_calib(IMG[1], IMG[0])
PROJ = jnp.asarray(CALIB.intrinsics_d.vector)


@pytest.fixture(scope="module")
def fused():
    """Hash volume with frame 0 fused at identity."""
    depth = synth.render_depth(jnp.eye(4), PROJ, IMG)
    vol, rs, state = hp.create_engine_state(SETTINGS, IMG)
    vol, rs, state, diag = hp.process_frame_hash(
        vol, rs, state, View(depth=depth), PROJ, SETTINGS
    )
    return depth, vol, rs, state, diag


def test_allocation_happens(fused):
    depth, vol, rs, state, diag = fused
    n_alloc = SETTINGS.hashing.n_blocks - 2 - int(vol.last_free_block)
    assert n_alloc > 50, f"only {n_alloc} blocks allocated"
    assert int(rs.n_visible) >= n_alloc
    # every visible id refers to an allocated entry or a planned one
    ids = np.asarray(rs.visible_ids)
    n = int(rs.n_visible)
    assert (ids[:n] >= 0).all()


def test_raycast_matches_depth(fused):
    depth, vol, rs, state, diag = fused
    res = hp.raycast_hash(vol, rs, jnp.eye(4), PROJ, IMG, SETTINGS)
    pts = res.points
    found = np.asarray(pts[..., 3]) > 0
    gt_valid = np.asarray(depth) > 0
    assert found[gt_valid].mean() > 0.85
    z_ray = np.asarray(pts[..., 2]) * SETTINGS.scene.voxel_size
    err = np.abs(z_ray - np.asarray(depth))[found & gt_valid]
    assert np.median(err) < SETTINGS.scene.voxel_size


def test_expected_depth_ranges_bound_surface(fused):
    depth, vol, rs, state, diag = fused
    zmin, zmax, _ntb = hp.expected_depth_ranges(vol, rs, jnp.eye(4), PROJ, IMG, SETTINGS)
    d = np.asarray(depth)
    zmin = np.asarray(zmin)
    zmax = np.asarray(zmax)
    m = d > 0
    # the true surface must lie inside the per-pixel range for almost all pixels
    inside = (d >= zmin - 1e-3) & (d <= zmax + 1e-3)
    assert inside[m].mean() > 0.95
    # and the range must be much tighter than the full frustum on average
    full = SETTINGS.scene.view_frustum_max - SETTINGS.scene.view_frustum_min
    assert (zmax - zmin)[m].mean() < 0.7 * full


@pytest.mark.parametrize("big_cap", [None, 0])
def test_expected_depth_ranges_near_block_tier(monkeypatch, big_cap):
    """A block near the camera spans more cells than the per-block tile: the
    compacted near tier still rasterizes its range; with no room in that
    tier it is left out and counted in n_too_big."""
    if big_cap is not None:
        monkeypatch.setattr(hp, "MINMAX_BIG_CAP", big_cap)
    hpar = SETTINGS.hashing
    vol = hv.create_hash(hpar)
    vol, _vt, widx = hv.insert_blocks(
        vol, jnp.zeros((hpar.n_entries,), jnp.int32),
        jnp.array([[0, 0, 1]], jnp.int32), jnp.array([True]), hpar,
    )
    rs = hv.create_render_state(hpar)
    rs = rs._replace(visible_ids=rs.visible_ids.at[0].set(widx[0]))
    img = (240, 320)  # 0.2 m block 0.2-0.4 m away: ~20 of the 40 cell columns
    proj = jnp.asarray(default_calib(img[1], img[0]).intrinsics_d.vector)
    zmin, zmax, n_too_big = hp.expected_depth_ranges(vol, rs, jnp.eye(4), proj, img, SETTINGS)
    covered = np.asarray(zmax) > np.asarray(zmin)
    if big_cap is None:
        assert int(n_too_big) == 0
        assert covered.mean() > 0.1  # the block's pixels get a real range
        np.testing.assert_allclose(np.asarray(zmax)[covered].max(), 0.4, atol=1e-5)
    else:
        assert int(n_too_big) == 1
        assert not covered.any()


def test_e2e_hash_sequence():
    src = synth.SyntheticSource(CALIB, n_frames=8, img_size=IMG)
    vol, rs, state = hp.create_engine_state(SETTINGS, IMG)
    errs = []
    for _ in range(src.n_frames):
        depth, _rgb, gt = src.get_images()
        vol, rs, state, diag = hp.process_frame_hash(
            vol, rs, state, View(depth=depth), PROJ, SETTINGS
        )
        err = se3.se3_log(state.pose @ se3.invert(gt))
        errs.append(float(jnp.linalg.norm(err[:3])))
    assert errs[-1] < 0.03, f"trajectory errors: {errs}"
    assert max(errs) < 0.04, f"trajectory errors: {errs}"


def test_dense_and_hash_agree():
    """The hash pipeline must track the same trajectory as the dense pipeline
    (the analogue of the reference's CPU-vs-CUDA oracle, SURVEY.md §4)."""
    from infinitam_tpu.config import PlainVoxelArrayParams
    from infinitam_tpu.engine import dense_pipeline as dp

    dense_settings = Settings(
        scene=SETTINGS.scene,
        plain=PlainVoxelArrayParams(size=(128, 128, 100), offset=(-64, -64, 0)),
        tracking=SETTINGS.tracking,
    )
    src = synth.SyntheticSource(CALIB, n_frames=5, img_size=IMG)
    vol_h, rs, st_h = hp.create_engine_state(SETTINGS, IMG)
    vol_d, st_d = dp.create_engine_state(dense_settings, IMG)
    for _ in range(src.n_frames):
        depth, _rgb, gt = src.get_images()
        view = View(depth=depth)
        vol_h, rs, st_h, _ = hp.process_frame_hash(vol_h, rs, st_h, view, PROJ, SETTINGS)
        vol_d, st_d, _ = dp.process_frame_dense(vol_d, st_d, view, PROJ, dense_settings)
    delta = se3.se3_log(st_h.pose @ se3.invert(st_d.pose))
    assert float(jnp.linalg.norm(delta[:3])) < 0.005


def test_divergence_keeps_last_good_pose_and_map():
    """Failure-detection policy (SURVEY.md §5): a garbage frame (all-invalid
    depth -> tracker f=1e5 sentinel) must not move the pose or corrupt the
    volume, and the next good frame must continue tracking."""
    import jax.numpy as jnp
    import numpy as np

    from infinitam_tpu.calib import default_calib
    from infinitam_tpu.engine import hash_pipeline as hp
    from infinitam_tpu.engine.view_builder import View
    from infinitam_tpu.io import synth

    S = hash_settings()
    img = (60, 80)
    calib = default_calib(img[1], img[0])
    proj = jnp.asarray(calib.intrinsics_d.vector)
    src = synth.SyntheticSource(calib, n_frames=4, img_size=img)
    vol, rs, state = hp.create_engine_state(S, img)

    for _ in range(2):
        depth, _rgb, gt = src.get_images()
        vol, rs, state, diag = hp.process_frame_hash(vol, rs, state, View(depth=depth), proj, S)

    pose_before = np.asarray(state.pose)
    sdf_sum_before = float(jnp.sum(jnp.abs(hv.vox_sdf_q(vol.vox) - 32767)))

    garbage = jnp.full(img, -1.0, dtype=jnp.float32)  # no valid depth at all
    vol, rs, state, diag = hp.process_frame_hash(vol, rs, state, View(depth=garbage), proj, S)
    assert float(diag.f) >= S.tracking.divergence_f_threshold
    np.testing.assert_allclose(np.asarray(state.pose), pose_before, atol=1e-7)
    sdf_sum_after = float(jnp.sum(jnp.abs(hv.vox_sdf_q(vol.vox) - 32767)))
    np.testing.assert_allclose(sdf_sum_after, sdf_sum_before, rtol=1e-6)

    depth, _rgb, gt = src.get_images()
    vol, rs, state, diag = hp.process_frame_hash(vol, rs, state, View(depth=depth), proj, S)
    from infinitam_tpu.utils import se3
    err = se3.se3_log(state.pose @ se3.invert(jnp.asarray(gt)))
    assert float(jnp.linalg.norm(err[:3])) < 0.05


def test_compact_allocator_matches_legacy_oracle():
    """Property test: the compact candidate-space allocator and
    the legacy full-plane oracle must agree on WHAT exists — the allocated
    block-position set and the visible-entry position set — over a replayed
    sequence that includes out-of-grid geometry (a deliberately small
    working grid pushes far scene content onto the hash-probe OOG path).
    Per-frame winner election order may differ in contended buckets (both
    paths defer losers to the next frame, like the reference's benign CUDA
    race), so sets are compared with a small per-frame tolerance and
    exactly at the end."""
    from infinitam_tpu.config import BlockGridParams

    settings = hash_settings().replace(
        block_grid=BlockGridParams(dims=(12, 12, 12), origin=(-6, -6, 0)),
    )
    src = synth.SyntheticSource(CALIB, n_frames=5, img_size=IMG)
    volC, rsC, _st = hp.create_engine_state(settings, IMG)
    volL, rsL, _st = hp.create_engine_state(settings, IMG)
    rsL = rsL._replace(cell_claim=None, entry_epoch=None, epoch=None)

    def alloc_set(vol):
        ptr = np.asarray(vol.entry_ptr)
        pos = np.asarray(vol.entry_pos)
        live = ptr >= 0
        return set(map(tuple, pos[live]))

    def vis_set(vol, rs):
        ids = np.asarray(rs.visible_ids)
        ids = ids[ids >= 0]
        pos = np.asarray(vol.entry_pos)[ids]
        return set(map(tuple, pos))

    for i in range(5):
        depth, _rgb, gt = src.get_images()
        pose = jnp.asarray(gt)
        volC, rsC, _ovC = hp.allocate_scene_from_depth(
            volC, rsC, depth, pose, PROJ, settings
        )
        assert rsC.cell_claim is not None  # compact path taken
        volL, rsL, _ovL = hp.allocate_scene_from_depth(
            volL, rsL, depth, pose, PROJ, settings
        )
        aC, aL = alloc_set(volC), alloc_set(volL)
        assert len(aC ^ aL) <= 4, f"frame {i}: alloc sets diverged by {len(aC ^ aL)}"
        vC, vL = vis_set(volC, rsC), vis_set(volL, rsL)
        assert len(vC ^ vL) <= 4, f"frame {i}: visible sets diverged by {len(vC ^ vL)}"
        # the compact visible list must never contain a duplicate entry
        ids = np.asarray(rsC.visible_ids)
        ids = ids[ids >= 0]
        assert len(ids) == len(set(ids.tolist())), "duplicate visible ids"

    # converged: after the last frame both paths describe the same world
    assert alloc_set(volC) == alloc_set(volL)
    assert vis_set(volC, rsC) == vis_set(volL, rsL)
