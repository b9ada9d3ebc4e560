"""Generate the committed real-file replay fixtures:
record ~10 synthetic frames to PGM via RecordingSource (the same path a
live capture uses), plus the reference-format calib text and ground-truth
poses. Small 60×80 frames keep the fixture directory ~100 KB.

Run once; the output under tests/fixtures/replay/ is committed."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from infinitam_tpu.calib import default_calib, write_rgbd_calib  # noqa: E402
from infinitam_tpu.io import synth  # noqa: E402
from infinitam_tpu.io.sources import RecordingSource  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "tests", "fixtures", "replay")
IMG = (60, 80)
N = 10


def main():
    os.makedirs(OUT, exist_ok=True)
    calib = default_calib(IMG[1], IMG[0])
    src = synth.SyntheticSource(calib, n_frames=N, img_size=IMG)
    rec = RecordingSource(src, OUT)
    poses = []
    for _ in range(N):
        _d, _r, gt = rec.get_images()
        poses.append(np.asarray(gt))
    np.save(os.path.join(OUT, "gt_poses.npy"), np.stack(poses))
    with open(os.path.join(OUT, "calib.txt"), "w") as f:
        f.write(write_rgbd_calib(calib))
    print(f"wrote {N} frames + calib + poses to {OUT}")


if __name__ == "__main__":
    main()
