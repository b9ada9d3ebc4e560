"""Offline viewer: orbit ("turntable") freeview renders of a fused scene.

The minimal stand-in for the reference's GLUT UIEngine (Engine/UIEngine.cpp
— 3-pane window, mouse freeview): no display exists in this deployment, so
the viewer replays (or restores) a scene and renders N freeview frames on an
orbit around it to PNG/PPM, plus an HTML strip for quick inspection. The
freeview path exercises the same FindVisibleBlocks → raycast machinery as
the reference's freeview pane (ITMMainEngine.cpp:176-182).

Usage:
    # fuse the synthetic sequence, then render a 24-frame orbit
    python -m infinitam_tpu.apps.viewer --synthetic --frames 12 \
        --orbit 24 --out /tmp/orbit
    # restore a checkpoint instead of replaying
    python -m infinitam_tpu.apps.viewer --snapshot snap.npz --out /tmp/orbit
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def orbit_pose(center: np.ndarray, radius: float, theta: float, height: float) -> np.ndarray:
    """world→camera pose on a circle around `center`, looking at it."""
    C = center + np.array([radius * np.sin(theta), height, radius * np.cos(theta)])
    fwd = center - C
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, -1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    up2 = np.cross(fwd, right)
    R = np.stack([right, up2, fwd])  # rows: camera axes in world
    M = np.eye(4, dtype=np.float32)
    M[:3, :3] = R
    M[:3, 3] = -R @ C
    return M


def main(argv=None):
    ap = argparse.ArgumentParser(description="orbit-render a fused scene")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--snapshot", default=None, help="engine checkpoint (.npz)")
    ap.add_argument("--frames", type=int, default=12, help="frames to fuse first")
    ap.add_argument("--orbit", type=int, default=24, help="orbit render count")
    ap.add_argument("--radius", type=float, default=2.0)
    ap.add_argument("--center", type=float, nargs=3, default=[0.0, 0.0, 1.5])
    ap.add_argument("--mode", default="raycast", choices=["raycast", "normals", "depth", "weight", "colour"])
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--voxel-size", type=float, default=0.01)
    ap.add_argument("--mu", type=float, default=0.04)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from infinitam_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from infinitam_tpu.calib import default_calib
    from infinitam_tpu.config import SceneParams, Settings
    from infinitam_tpu.engine.main_engine import MainEngine
    from infinitam_tpu.io import synth
    from infinitam_tpu.utils import checkpoint as ckpt
    from infinitam_tpu.utils.image_io import write_image

    calib = default_calib(args.width, args.height)
    settings = Settings(scene=SceneParams(voxel_size=args.voxel_size, mu=args.mu))
    engine = MainEngine(settings, calib, (args.height, args.width))

    if args.snapshot:
        ckpt.load_engine(args.snapshot, engine)
        print(f"restored snapshot at frame {engine.frame_no}")
    else:
        src = synth.SyntheticSource(calib, n_frames=args.frames,
                                    img_size=(args.height, args.width))
        for i in range(args.frames):
            depth, _rgb, _gt = src.get_images()
            d = engine.process_frame(metric_depth=depth)
            print(f"fused frame {i}: inliers={d.get('num_valid', 0)}")

    os.makedirs(args.out, exist_ok=True)
    names = []
    center = np.asarray(args.center)
    for k in range(args.orbit):
        theta = 2.0 * np.pi * k / max(args.orbit, 1)
        M = orbit_pose(center, args.radius, theta, height=0.0)
        img = engine.get_image(args.mode, pose=M)
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        name = f"orbit_{k:04d}.png"
        write_image(os.path.join(args.out, name), img[..., :3].astype(np.uint8))
        names.append(name)
        print(f"rendered {name} ({(img > 0).mean():.2%} coverage)")

    with open(os.path.join(args.out, "index.html"), "w") as f:
        f.write("<html><body style='background:#111'>\n")
        for n in names:
            f.write(f"<img src='{n}' style='width:240px;margin:2px'>\n")
        f.write("</body></html>\n")
    print(f"orbit written to {args.out}/index.html")
    return 0


if __name__ == "__main__":
    sys.exit(main())
