"""Triton raycast kernel (ops/raycast_kernel.py) against the XLA reference
march (ops/raycast.raycast_rays), in Pallas interpret mode on the CPU.

Both march the same rays with the same step rule and refinement, so hit
masks must agree exactly and hit positions to float rounding. The compiled
kernel is checked on the card by the `gpu`-marked test below and by
chip_smoke.py phase f at 640×480.
"""

import jax
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
from infinitam_tpu.engine import hash_volume as hv
from infinitam_tpu.engine.view_builder import View
from infinitam_tpu.io import synth
from infinitam_tpu.ops import raycast as rc
from infinitam_tpu.ops import raycast_kernel as rk
from infinitam_tpu.utils import se3

IMG = (64, 64)


def make_settings() -> Settings:
    return Settings(
        scene=SceneParams(voxel_size=0.025, mu=0.1, view_frustum_min=0.3, view_frustum_max=3.0),
        hashing=VoxelBlockHashParams(
            n_buckets=0x4000,
            n_excess=0x400,
            n_blocks=0x1800,
            max_visible_blocks=0x1000,
        ),
        block_grid=BlockGridParams(dims=(32, 32, 32), origin=(-16, -16, 0)),
        tracking=TrackingParams(n_levels=3, min_valid_points=50),
        max_render_blocks=512,
    )


@pytest.fixture(scope="module")
def scene():
    settings = make_settings()
    calib = default_calib(IMG[1], IMG[0])
    proj = jnp.asarray(calib.intrinsics_d.vector)
    src = synth.SyntheticSource(calib, n_frames=2, img_size=IMG)
    depth, _rgb, _gt = src.get_images()
    vol, rs, state = hp.create_engine_state(settings, IMG)
    for _ in range(2):
        vol, rs, state, _diag = hp.process_frame_hash(
            vol, rs, state, View(depth=depth), proj, settings
        )
    return settings, depth, proj, vol, rs


def _rays(settings, vol, rs, pose, proj):
    sp = settings.scene
    zmin, zmax, _ = hp.expected_depth_ranges(vol, rs, pose, proj, IMG, settings)
    return rc.pixel_rays(se3.invert(pose), proj, IMG, 1.0 / sp.voxel_size, zmin, zmax)


def _kernel(settings, vol, rays, interpret=True):
    sp, gp = settings.scene, settings.block_grid
    grid = hv.get_block_grid(vol, gp, settings.hashing)
    return rk.raycast_grid(
        *rays, grid, vol.vox, sp.mu / sp.voxel_size, gp.dims, gp.origin,
        settings.hashing.block_size, interpret=interpret,
    )


def _reference(settings, vol, rays):
    sp, gp = settings.scene, settings.block_grid
    grid = hv.get_block_grid(vol, gp, settings.hashing)
    read = hv.make_grid_reader(vol, grid, gp, settings.hashing)
    return rc.raycast_rays(read, *rays, sp.mu / sp.voxel_size, settings.hashing.block_size)


def _assert_same(ref, out):
    ref, out = np.asarray(ref), np.asarray(out)
    f_r, f_k = ref[..., 3] > 0, out[..., 3] > 0
    np.testing.assert_array_equal(f_k, f_r)
    assert f_r.mean() > 0.3  # a real surface, not a vacuous all-miss
    np.testing.assert_allclose(out[..., :3], ref[..., :3], atol=1e-3)


@pytest.mark.parametrize("pose_twist", [None, (0.01, -0.02, 0.015, 0.02, -0.01, 0.01)])
def test_kernel_matches_reference_march(scene, pose_twist):
    """Hit mask and hit points of the kernel = the XLA march, from the fused
    camera pose and from a displaced one."""
    settings, _depth, proj, vol, rs = scene
    pose = jnp.eye(4) if pose_twist is None else se3.se3_exp(jnp.asarray(pose_twist))
    rays = _rays(settings, vol, rs, pose, proj)
    _assert_same(_reference(settings, vol, rays), _kernel(settings, vol, rays))


def test_kernel_depth_consistency(scene):
    """Kernel hits reproduce the fused synthetic depth."""
    settings, depth, proj, vol, rs = scene
    out = np.asarray(_kernel(settings, vol, _rays(settings, vol, rs, jnp.eye(4), proj)))
    found = out[..., 3] > 0
    gt_valid = np.asarray(depth) > 0
    assert found[gt_valid].mean() > 0.8
    z = out[..., 2] * settings.scene.voxel_size
    err = np.abs(z - np.asarray(depth))[found & gt_valid]
    assert np.median(err) < settings.scene.voxel_size


def test_kernel_ragged_ray_count_pads(scene):
    """A ray bundle that is not a multiple of the tile (7×9 rays) pads to
    whole tiles and crops back to the same answer as the reference."""
    settings, _depth, proj, vol, rs = scene
    rays = _rays(settings, vol, rs, jnp.eye(4), proj)
    sub = tuple(a[20:27, 25:34] for a in rays)
    out = _kernel(settings, vol, sub)
    assert out.shape == (7, 9, 4)
    _assert_same(_reference(settings, vol, sub), out)


def test_kernel_batches_under_vmap(scene):
    """vmap over lanes (the batched multi-sequence step) = each lane alone."""
    settings, _depth, proj, vol, rs = scene
    rays0 = _rays(settings, vol, rs, jnp.eye(4), proj)
    pose1 = se3.se3_exp(jnp.asarray([0.02, 0.0, -0.01, 0.0, 0.02, 0.0]))
    rays1 = _rays(settings, vol, rs, pose1, proj)
    empty = hp.create_engine_state(settings, IMG)[0]
    vols = jax.tree.map(lambda a, b: jnp.stack([a, b]), vol, empty)
    rays = tuple(jnp.stack([a, b]) for a, b in zip(rays0, rays1))
    out = jax.vmap(lambda v, r: _kernel(settings, v, r))(vols, rays)
    np.testing.assert_array_equal(np.asarray(out[0]), np.asarray(_kernel(settings, vol, rays0)))
    np.testing.assert_array_equal(np.asarray(out[1]), np.asarray(_kernel(settings, empty, rays1)))
    assert float(jnp.sum(out[1][..., 3])) == 0.0  # an empty map has no surface


def test_trilinear_exact_across_block_boundaries():
    """A flat wall whose zero crossing sits next to a block seam is hit at
    the stored field's interpolated zero: the trilinear taps read the
    neighbouring block exactly (no corner folding)."""
    S, mu_vox, Z0 = 8, 4.0, 15.6  # zero crossing 0.4 voxel before the seam at z=16
    dims, origin = (4, 4, 4), (-2, -2, 0)
    blocks, grid = [], np.full(dims, -1, np.int32)
    lz = np.arange(S**3) // (S * S)
    for bx in (-1, 0):
        for by in (-1, 0):
            for bz in (0, 1, 2, 3):
                sdf = np.clip((Z0 - (bz * S + lz)) / mu_vox, -1.0, 1.0)
                blocks.append(np.asarray(hv.pack_vox(hv.sdf_to_q(sdf), 1)))
                grid[bx - origin[0], by - origin[1], bz - origin[2]] = len(blocks) - 1
    vox = jnp.asarray(np.stack(blocks))
    n = 16
    xs = np.linspace(-6.0, 5.5, n, dtype=np.float32)
    px, py = np.meshgrid(xs, xs, indexing="ij")
    start = jnp.asarray(np.stack([px, py, np.full_like(px, 2.0)], -1))
    direction = jnp.asarray(np.broadcast_to(np.float32([0, 0, 1]), (n, n, 3)))
    l0, l1 = jnp.full((n, n), 2.0), jnp.full((n, n), 30.0)
    out = np.asarray(rk.raycast_grid(
        start, direction, l0, l1, jnp.asarray(grid), vox, mu_vox, dims, origin, S,
        interpret=True,
    ))
    assert (out[..., 3] > 0).all()
    q = np.round(np.clip((Z0 - np.array([15.0, 16.0])) / mu_vox, -1, 1) * hv.SDF_SCALE)
    z_expected = 15.0 + q[0] / (q[0] - q[1])  # zero of the stored, quantized field
    err = out[..., 2] - z_expected
    assert np.abs(err).max() < 0.01, f"max hit error {np.abs(err).max():.4f} voxels"


@pytest.mark.gpu
def test_compiled_kernel_matches_reference(scene, gpu):
    """On the card: the Triton-compiled kernel against the XLA march."""
    settings, _depth, proj, vol, rs = scene
    rays = _rays(settings, vol, rs, jnp.eye(4), proj)
    _assert_same(_reference(settings, vol, rays), _kernel(settings, vol, rays, interpret=False))
