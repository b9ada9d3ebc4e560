"""Synthetic RGB-D sequence generator — analytic-SDF scene + exact renderer.

The reference ships only the Teddy calibration, not its frames; tests and
benchmarks therefore replay a synthetic sequence: depth images are rendered by
sphere-tracing an analytic SDF along a known ground-truth trajectory, giving
an exact oracle for both fusion (the TSDF must converge to the analytic
surface) and tracking (estimated poses must match the trajectory).

Plays the role of the reference's ImageFileReader dataset replay
(Engine/ImageSourceEngine.cpp) as the correctness anchor, with ground truth.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from infinitam_tpu.utils import se3


def scene_sdf(p: jnp.ndarray) -> jnp.ndarray:
    """Analytic signed distance of the default test scene (metres).

    A sphere, a box, and a back wall — enough geometry to constrain all six
    pose DoF. p: [..., 3] world coords.
    """
    # sphere at (0.0, 0.1, 1.5), r = 0.35
    d_sphere = jnp.linalg.norm(p - jnp.array([0.0, 0.1, 1.5]), axis=-1) - 0.35
    # box at (-0.55, -0.2, 1.8), half-extents (0.25, 0.3, 0.25), rotated 30° about y
    c, s = np.cos(0.5), np.sin(0.5)
    Rb = jnp.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], dtype=jnp.float32)
    q = se3.rotate(Rb, p - jnp.array([-0.55, -0.2, 1.8]))
    hb = jnp.array([0.25, 0.3, 0.25])
    dq = jnp.abs(q) - hb
    d_box = jnp.linalg.norm(jnp.maximum(dq, 0.0), axis=-1) + jnp.minimum(
        jnp.max(dq, axis=-1), 0.0
    )
    # second sphere, right side
    d_sphere2 = jnp.linalg.norm(p - jnp.array([0.55, 0.25, 1.35]), axis=-1) - 0.2
    # back wall at z = 2.3
    d_wall = 2.3 - p[..., 2]
    return jnp.minimum(jnp.minimum(d_sphere, d_box), jnp.minimum(d_sphere2, d_wall))


def scene_color(p: jnp.ndarray) -> jnp.ndarray:
    """Procedural surface colour for the color-fusion path. [...,3] in 0..1.

    High-contrast multi-axis texture so the photometric energy is
    well-conditioned in all six pose DoF.
    """
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r = 0.5 + 0.25 * jnp.sin(x * 23.0 + z * 7.0) + 0.25 * jnp.sin(y * 17.0)
    g = 0.5 + 0.25 * jnp.sin(y * 19.0 - x * 11.0) + 0.25 * jnp.cos(z * 13.0)
    b = 0.5 + 0.25 * jnp.sin(z * 21.0 + y * 9.0) + 0.25 * jnp.cos(x * 15.0)
    return jnp.clip(jnp.stack([r, g, b], axis=-1), 0.0, 1.0)


@partial(jax.jit, static_argnames=("img_size", "n_steps"))
def render_depth(
    pose: jnp.ndarray,  # [4,4] world→camera
    proj: jnp.ndarray,  # (fx, fy, cx, cy)
    img_size: Tuple[int, int],
    t_min: float = 0.2,
    t_max: float = 4.0,
    n_steps: int = 96,
) -> jnp.ndarray:
    """Exact depth render by sphere tracing the analytic SDF. Returns [H, W]
    metric depth (z, not ray length) with −1 misses."""
    H, W = img_size
    fx, fy, cx, cy = proj[0], proj[1], proj[2], proj[3]
    inv = se3.invert(pose)
    xs = jnp.arange(W, dtype=jnp.float32)[None, :].repeat(H, axis=0)
    ys = jnp.arange(H, dtype=jnp.float32)[:, None].repeat(W, axis=1)
    dir_cam = jnp.stack([(xs - cx) / fx, (ys - cy) / fy, jnp.ones_like(xs)], axis=-1)
    ray_scale = jnp.linalg.norm(dir_cam, axis=-1)  # |d| for unit z
    origin = inv[:3, 3]
    dir_world = se3.rotate(inv, dir_cam)
    dir_world = dir_world / jnp.maximum(
        jnp.linalg.norm(dir_world, axis=-1, keepdims=True), 1e-12
    )

    def body(_, t):
        p = origin + t[..., None] * dir_world
        d = scene_sdf(p)
        return jnp.where(t < t_max, t + jnp.maximum(d, 1e-4) * 0.9, t)

    t0 = jnp.full((H, W), t_min, dtype=jnp.float32)
    t = jax.lax.fori_loop(0, n_steps, body, t0)
    p = origin + t[..., None] * dir_world
    hit = (scene_sdf(p) < 5e-3) & (t < t_max)
    # convert ray length to z-depth
    z = t / ray_scale
    return jnp.where(hit, z, -1.0)


@partial(jax.jit, static_argnames=("img_size", "n_steps"))
def render_rgbd(
    pose: jnp.ndarray,
    proj: jnp.ndarray,
    img_size: Tuple[int, int],
    t_min: float = 0.2,
    t_max: float = 4.0,
    n_steps: int = 96,
):
    """Depth + colour render (colour sampled at the hit point)."""
    depth = render_depth(pose, proj, img_size, t_min, t_max, n_steps)
    H, W = img_size
    fx, fy, cx, cy = proj[0], proj[1], proj[2], proj[3]
    inv = se3.invert(pose)
    xs = jnp.arange(W, dtype=jnp.float32)[None, :].repeat(H, axis=0)
    ys = jnp.arange(H, dtype=jnp.float32)[:, None].repeat(W, axis=1)
    z = jnp.where(depth > 0, depth, 1.0)
    p_cam = jnp.stack([z * (xs - cx) / fx, z * (ys - cy) / fy, z], axis=-1)
    p_world = se3.apply(inv, p_cam)
    rgb = jnp.where((depth > 0)[..., None], scene_color(p_world), 0.0)
    return depth, rgb


def make_trajectory(n_frames: int, scale: float = 1.0, step: float = 0.01) -> np.ndarray:
    """Smooth ground-truth trajectory of world→camera poses [N, 4, 4]: a slow
    arc with gentle rotation exercising all six DoF. Per-frame motion is
    bounded (~1.5 cm / ~0.5° at the default step) independent of n_frames,
    matching a 30 fps handheld camera as the reference assumes."""
    poses = []
    for i in range(n_frames):
        s = i * step
        t = np.array(
            [0.25 * np.sin(2 * np.pi * s), 0.12 * np.sin(4 * np.pi * s), 0.18 * s],
            dtype=np.float32,
        ) * scale
        w = np.array(
            [0.10 * np.sin(2 * np.pi * s), 0.22 * s, 0.06 * np.sin(2 * np.pi * s)],
            dtype=np.float32,
        ) * scale
        twist = np.concatenate([t, w])
        poses.append(np.asarray(se3.se3_exp(jnp.asarray(twist))))
    return np.stack(poses)


class SyntheticSource:
    """Pull-style frame source matching the reference ImageSourceEngine
    contract (calib + getImages), with ground-truth poses attached."""

    def __init__(self, calib, n_frames: int = 50, img_size=None, with_rgb: bool = False):
        self.calib = calib
        intr = calib.intrinsics_d
        self.img_size = img_size or (intr.height, intr.width)
        self.proj = jnp.asarray(intr.vector)
        self.gt_poses = make_trajectory(n_frames)
        self.n_frames = n_frames
        self.with_rgb = with_rgb
        self._i = 0

    def has_more_images(self) -> bool:
        return self._i < self.n_frames

    def get_images(self):
        pose = jnp.asarray(self.gt_poses[self._i])
        if self.with_rgb:
            depth, rgb = render_rgbd(pose, self.proj, self.img_size)
        else:
            depth, rgb = render_depth(pose, self.proj, self.img_size), None
        self._i += 1
        return depth, rgb, pose
