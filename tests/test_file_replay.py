"""Real-file end-to-end replay (the other ATE checks use in-memory
synthetic frames; this replays committed PGM FILES
through the full file → raw-depth → disparity-conversion → view → track →
fuse path, the reference's own validation workflow:
`./InfiniTAM Teddy/calib.txt Teddy/Frames/%04i.ppm Teddy/Frames/%04i.pgm`
(ref: README.md §2, Engine/ImageSourceEngine.cpp:60-140)."""

import os

import jax.numpy as jnp
import numpy as np

from infinitam_tpu.config import tiny_test_settings
from infinitam_tpu.engine.main_engine import MainEngine
from infinitam_tpu.io.sources import ImageFileReader
from infinitam_tpu.utils import se3

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "replay")


def test_file_replay_tracks():
    """ImageFileReader over the committed PGM fixtures → MainEngine
    (raw-depth path: uint16 mm → affine disparity conversion) must track
    the recorded trajectory to a few mm."""
    src = ImageFileReader(
        os.path.join(FIX, "calib.txt"),
        rgb_mask="",
        depth_mask=os.path.join(FIX, "depth_%04i.pgm"),
    )
    # the recorded mm depth converts via the affine model (a=1/1000, b=0)
    assert src.calib.disparity.type == "affine"
    assert abs(src.calib.disparity.a - 1e-3) < 1e-9

    gt = np.load(os.path.join(FIX, "gt_poses.npy"))
    img = (src.calib.intrinsics_d.height, src.calib.intrinsics_d.width)
    eng = MainEngine(tiny_test_settings(), src.calib, img)

    n = 0
    while src.has_more_images():
        depth, _rgb = src.get_images()
        assert depth.dtype == np.uint16
        diag = eng.process_frame(raw_depth=depth)
        n += 1
    assert n == gt.shape[0] == 10

    err = se3.se3_log(
        jnp.asarray(eng.get_pose()) @ se3.invert(jnp.asarray(gt[-1]))
    )
    t_err = float(jnp.linalg.norm(err[:3]))
    r_err = float(jnp.linalg.norm(err[3:]))
    # mm-quantized file depth adds ≤0.5 mm noise on top of the synthetic
    # drive's ~4 mm; 1 cm bounds it with margin
    assert t_err < 0.01, f"file replay diverged: {t_err * 1000:.1f} mm"
    assert np.degrees(r_err) < 1.0
    assert diag["num_valid"] > 500

    # the fused map renders from the tracked pose
    shot = eng.get_image("raycast")
    assert shot.shape == img and shot.max() > 0
