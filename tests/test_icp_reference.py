"""Point-to-plane ICP residuals and the normal-equation reduction
(ops/icp.compute_residuals + reduce_gh) against a per-pixel NumPy reference
of the reference tracker (DeviceAgnostic/ITMDepthTracker.h:8-105,
ITMDepthTracker_CPU.cpp:14-79 ComputeGandH), at pyramid levels 0 and 1 and
under a displaced pose."""

import jax.numpy as jnp
import numpy as np
import pytest

from infinitam_tpu.ops import icp
from infinitam_tpu.utils import se3


def make_scene(H=64, W=64, seed=0):
    """Smooth synthetic scene maps + a noisy depth frame with holes."""
    rng = np.random.default_rng(seed)
    proj = np.array([80.0, 80.0, W / 2 - 0.5, H / 2 - 0.5], np.float32)
    xs = np.arange(W, dtype=np.float32)[None, :]
    ys = np.arange(H, dtype=np.float32)[:, None]
    z = 1.5 + 0.2 * np.sin(xs / 17.0) * np.cos(ys / 13.0)
    px = z * (xs - proj[2]) / proj[0]
    py = z * (ys - proj[3]) / proj[1]
    pts = np.stack([px, py, z, np.ones_like(z)], -1)
    pts[..., 3] = np.where(rng.uniform(size=(H, W)) < 0.07, -1.0, 1.0)
    n = np.zeros((H, W, 4), np.float32)
    n[..., 2] = -1.0
    n[..., 0] = 0.1 * np.sin(ys / 11.0)
    n[..., :3] /= np.linalg.norm(n[..., :3], axis=-1, keepdims=True)
    n[..., 3] = pts[..., 3]
    depth = (z + rng.normal(0, 0.002, size=z.shape)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.05] = -1.0
    return depth, proj, pts.astype(np.float32), n


def numpy_residuals(depth, vproj, pts, nrm, sproj, inv_pose, scene_pose, thresh):
    """Per-pixel loop over the reference's computePerPointGH_Depth_Ab."""
    H, W = depth.shape
    Hs, Ws = pts.shape[:2]
    b = np.zeros((H, W))
    A = np.zeros((H, W, 6))
    valid = np.zeros((H, W), bool)
    for y in range(H):
        for x in range(W):
            d = float(depth[y, x])
            if d <= 1e-8:
                continue
            pc = np.array([d * (x - vproj[2]) / vproj[0], d * (y - vproj[3]) / vproj[1], d])
            p = inv_pose[:3, :3] @ pc + inv_pose[:3, 3]
            ps = scene_pose[:3, :3] @ p + scene_pose[:3, 3]
            if ps[2] <= 0:
                continue
            u = sproj[0] * ps[0] / ps[2] + sproj[2]
            v = sproj[1] * ps[1] / ps[2] + sproj[3]
            if not (0 <= u <= Ws - 2 and 0 <= v <= Hs - 2):
                continue
            x0, y0 = int(np.floor(u)), int(np.floor(v))
            ax, ay = u - x0, v - y0
            corners = [(y0, x0, (1 - ax) * (1 - ay)), (y0, x0 + 1, ax * (1 - ay)),
                       (y0 + 1, x0, (1 - ax) * ay), (y0 + 1, x0 + 1, ax * ay)]
            if any(pts[cy, cx, 3] < 0 for cy, cx, _w in corners):
                continue
            tgt = sum(wt * pts[cy, cx, :3].astype(np.float64) for cy, cx, wt in corners)
            diff = tgt - p
            if diff @ diff > thresh:
                continue
            nn = sum(wt * nrm[cy, cx, :3].astype(np.float64) for cy, cx, wt in corners)
            b[y, x] = nn @ diff
            A[y, x] = np.concatenate([np.cross(nn, p), nn])
            valid[y, x] = True
    return b, A, valid


def _check(level, twist, thresh, seed):
    depth, proj, pts, nrm = make_scene(seed=seed)
    d_lvl = depth[:: 2**level, :: 2**level]
    vproj = proj * 0.5**level
    inv_pose = se3.se3_exp(jnp.asarray(twist, jnp.float32))
    scene_pose = jnp.eye(4, dtype=jnp.float32)
    b, A, valid, _p = icp.compute_residuals(
        jnp.asarray(d_lvl), jnp.asarray(vproj), jnp.asarray(pts), jnp.asarray(nrm),
        jnp.asarray(proj), inv_pose, scene_pose, thresh,
    )
    rb, rA, rvalid = numpy_residuals(
        d_lvl, vproj.astype(np.float64), pts, nrm, proj.astype(np.float64),
        np.asarray(inv_pose, np.float64), np.eye(4), thresh,
    )
    valid = np.asarray(valid)
    assert (valid == rvalid).mean() > 0.998, f"valid sets differ at {(valid != rvalid).sum()}"
    both = valid & rvalid
    assert both.sum() > 0.3 * valid.size
    np.testing.assert_allclose(np.asarray(b)[both], rb[both], atol=2e-5)
    np.testing.assert_allclose(np.asarray(A)[both], rA[both], atol=2e-4)

    # the reduction, over the same inputs, in float64
    gh = icp.reduce_gh(b, A, jnp.asarray(valid), 100)
    Av = np.asarray(A, np.float64)[valid]
    bv = np.asarray(b, np.float64)[valid]
    n = int(valid.sum())
    assert int(gh.num_valid) == n
    np.testing.assert_allclose(gh.hessian, Av.T @ Av, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gh.nabla, Av.T @ bv, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(gh.f, np.sqrt(np.sum(bv**2)) / n, rtol=1e-4)


@pytest.mark.parametrize("level", [0, 1])
def test_residuals_and_normal_equations_match_numpy(level):
    _check(level, [0.004, -0.006, 0.003, 0.004, -0.002, 0.006], 0.04, seed=0)


def test_displaced_pose_matches_numpy():
    """A pose shifting the projection by ~13 px (0.25 m lateral at f=80,
    z=1.5): the correspondences move and still match the reference."""
    _check(0, [0.25, 0.0, 0.0, 0.0, 0.01, 0.003], 0.1 * 0.1, seed=5)


def test_reduce_gh_sentinel_below_min_valid():
    """Too few correspondences → the reference's f = 1e5 sentinel."""
    b = jnp.ones((8, 8))
    A = jnp.ones((8, 8, 6))
    valid = jnp.zeros((8, 8), bool).at[0, :5].set(True)
    gh = icp.reduce_gh(b, A, valid, 100)
    assert float(gh.f) == 1e5
    assert int(gh.num_valid) == 5
