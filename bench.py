"""Benchmark: fused+tracked 640×480 frames/s/chip on a Teddy-like replay.

Runs the voxel-block-hash pipeline at the REFERENCE default operating point
— voxel 5 mm, mu 2 cm, 640×480, 5-level ICP pyramid (reference:
ITMLibSettings.cpp:10) — over a synthetic Teddy-like sequence (the reference
repo ships only Teddy's calibration, not its frames — SURVEY.md §6). A
second config at voxel 1 cm / mu 4 cm (same mu/voxel ratio) is reported
alongside.

The replay runs as ONE on-device program (lax.scan over the frame
recursion, hash_pipeline.process_sequence_hash): per-frame math and the
sequential track→fuse→raycast dependency are identical to frame-at-a-time
dispatch, but the host submits once per sequence.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "frames/s", "vs_baseline": N/100, ...}
vs_baseline is against BASELINE.json's ≥100 fps/chip target.
"""

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from infinitam_tpu.calib import default_calib
from infinitam_tpu.config import (
    BlockGridParams,
    SceneParams,
    Settings,
    TrackingParams,
    VoxelBlockHashParams,
)
from infinitam_tpu.engine import hash_pipeline as hp
from infinitam_tpu.io import synth
from infinitam_tpu.utils import se3

IMG = (480, 640)
N_FRAMES = 30
N_WARM = 2


def reference_settings() -> Settings:
    """The reference's default operating point (ITMLibSettings.cpp:10):
    voxel 5 mm, mu 2 cm, frustum 0.35-3 m. Capacity notes: 4 cm blocks →
    the 64³ working grid would cover only ±1.28 m laterally, so the grid
    widens to 96×96×80 (±1.92 m × 3.2 m — the full frustum); visibility
    runs ~4× the 1 cm block count, so the render/fuse windows double."""
    return Settings(
        scene=SceneParams(voxel_size=0.005, mu=0.02, view_frustum_min=0.35,
                          view_frustum_max=3.0),
        hashing=VoxelBlockHashParams(),
        tracking=TrackingParams(),
        block_grid=BlockGridParams(dims=(96, 96, 80), origin=(-48, -48, 0)),
        alloc_subsample=3,  # 4 cm blocks span ≥7 px at 3 m → stride ≤3 taps each
        max_fused_blocks=16384,
        max_render_blocks=16384,
    )


def teddy_1cm_settings() -> Settings:
    """Voxel 1 cm / mu 4 cm (same mu/voxel ratio as the reference default
    at a volume the synthetic scene fills)."""
    return Settings(
        scene=SceneParams(voxel_size=0.01, mu=0.04, view_frustum_min=0.35,
                          view_frustum_max=3.0),
        # ~2 k visible blocks at 1 cm — an 8 k visible-list cap keeps the
        # compaction/recheck passes (cost ∝ static cap) at 4× headroom
        hashing=VoxelBlockHashParams(max_visible_blocks=0x2000),
        tracking=TrackingParams(),
        # safe_alloc_stride allows 7, but the coarser allocation sampling
        # measurably degrades map completeness at silhouettes (ATE 8.9 →
        # 11.1 mm at stride 6); stay at the denser stride
        alloc_subsample=4,
    )


def run_config(settings: Settings, with_color: bool = False):
    from infinitam_tpu.config import assert_alloc_stride_safe

    calib = default_calib(IMG[1], IMG[0])
    assert_alloc_stride_safe(settings, calib.intrinsics_d.fx)
    proj = jnp.asarray(calib.intrinsics_d.vector)
    src = synth.SyntheticSource(
        calib, n_frames=N_FRAMES, img_size=IMG, with_rgb=with_color
    )
    frames = [src.get_images() for _ in range(N_FRAMES)]
    depths = jnp.asarray(np.stack([np.asarray(d) for d, _r, _g in frames]))
    kw = {}
    if with_color:
        kw = dict(
            rgbs=jnp.asarray(np.stack([np.asarray(r) for _d, r, _g in frames])),
            proj_rgb=jnp.asarray(calib.intrinsics_rgb.vector),
            rgb_to_depth=jnp.asarray(calib.rgb_to_depth),
        )

    # correctness + compile run: the full replay from a fresh map
    vol, rs, state = hp.create_engine_state(settings, IMG)
    vol, rs, state, poses, diags = hp.process_sequence_hash(
        vol, rs, state, depths, proj, settings, **kw
    )
    jax.block_until_ready(poses)

    # timed run: identical program (shape-cached), fresh map — measures the
    # steady replay including first-frame allocation bursts
    vol2, rs2, state2 = hp.create_engine_state(settings, IMG)
    jax.block_until_ready(vol2.vox)
    t0 = time.perf_counter()
    _v, _r, _s, poses2, _d2 = hp.process_sequence_hash(
        vol2, rs2, state2, depths, proj, settings, **kw
    )
    jax.block_until_ready(poses2)
    dt = time.perf_counter() - t0
    fps = N_FRAMES / dt

    ate_rmse, rot_rmse_deg = trajectory_errors(
        np.asarray(poses), [gt for _d, _r, gt in frames]
    )
    # silent-cap counters: MAX over the whole replay, plus the last frame's
    # visibility
    dmax = jax.tree.map(lambda a: np.asarray(a).max(axis=0), diags)
    n_vis_last = int(np.asarray(diags.n_visible)[-1])
    diag_str = f"n_visible(last)={n_vis_last} " + " ".join(
        f"max_{k}={int(getattr(dmax, k))}" for k in CAP_COUNTERS
    )
    return fps, ate_rmse, rot_rmse_deg, diag_str


# FrameDiagnostics fields that count silently degraded work; all 0 on a
# healthy replay
CAP_COUNTERS = ("n_alloc_overflow", "n_render_overflow", "n_too_big_blocks")


def trajectory_errors(poses, gts) -> tuple:
    """(ATE-RMSE in metres, rotation-error RMSE in degrees) of estimated
    world→camera poses against ground truth. The accuracy bar is BASELINE.md's
    "ATE within 1 cm of reference trajectory"; the synthetic sequence's exact
    ground truth stands in for the reference trajectory. Frame 0 has no
    tracking yet and is skipped, like the reference's first frame. Rotation
    gates alongside, so a rotation drift cannot hide behind close camera
    centres."""
    errs, rerrs = [], []
    for pose, gt in list(zip(poses, gts))[1:]:
        pose = np.asarray(pose, np.float64)
        gt = np.asarray(gt, np.float64)
        c_est = np.linalg.inv(pose)[:3, 3]
        c_gt = np.linalg.inv(gt)[:3, 3]
        errs.append(np.sum((c_est - c_gt) ** 2))
        rerrs.append(rotation_angle_deg(pose[:3, :3] @ gt[:3, :3].T) ** 2)
    return float(np.sqrt(np.mean(errs))), float(np.sqrt(np.mean(rerrs)))


def rotation_angle_deg(R) -> float:
    """Rotation angle of a 3×3 rotation matrix in degrees, accurate for
    small angles too (atan2 of the sine and cosine parts; arccos of the
    trace alone loses ~0.02° to float32 rounding near zero)."""
    R = np.asarray(R, np.float64)
    sin = 0.5 * np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    cos = 0.5 * (np.trace(R) - 1.0)
    return float(np.degrees(np.arctan2(sin, cos)))


def run_swap_ratio():
    """Swap-tier overhead: per-frame-dispatch fps with and without the host
    swap exchange at the 1 cm operating point. Both paths pay the same
    per-dispatch overhead, so the RATIO isolates the swap tier's cost."""
    from infinitam_tpu.config import SwappingMode
    from infinitam_tpu.engine.main_engine import MainEngine

    calib = default_calib(IMG[1], IMG[0])
    N_SW = 46
    N_WARM_SW = 14  # long warmup: covers the exchange's program variants
    res = {}
    for tag, mode in (("noswap", SwappingMode.DISABLED),
                      ("swap", SwappingMode.ENABLED)):
        settings = teddy_1cm_settings().replace(swapping_mode=mode)
        eng = MainEngine(settings, calib, IMG)
        src = synth.SyntheticSource(calib, n_frames=N_SW, img_size=IMG)
        frames = [src.get_images() for _ in range(N_SW)]
        for d, _r, _g in frames[:N_WARM_SW]:
            eng.process_frame(metric_depth=d)
        jax.block_until_ready(eng.tracking_state.pose)
        # windowed timing: syncing every frame would serialize the pipelined
        # exchange (its host halves overlap later frames' device work);
        # 8-frame windows keep the pipeline intact and the median window
        # rejects hiccups + one-time program-variant compiles
        W = 8
        times = []
        rest = frames[N_WARM_SW:]
        for w0 in range(0, len(rest) - W + 1, W):
            t0 = time.perf_counter()
            for d, _r, _g in rest[w0:w0 + W]:
                eng.process_frame(metric_depth=d)
            jax.block_until_ready(eng.tracking_state.pose)
            times.append((time.perf_counter() - t0) / W)
        res[tag] = 1.0 / float(np.median(times))
    return res["swap"] / res["noswap"], res["noswap"], res["swap"]


def main():
    import os

    from infinitam_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    only = os.environ.get("ITPU_BENCH_CONFIG", "")  # dev: 5mm|1cm|color|swap
    if only == "swap":
        ratio, fps_ns, fps_sw = run_swap_ratio()
        print(json.dumps({"metric": "swap-mode fps ratio (dev)",
                          "value": round(ratio, 3), "unit": "x",
                          "vs_baseline": round(ratio / 0.85, 3),
                          "fps_noswap": round(fps_ns, 2),
                          "fps_swap": round(fps_sw, 2)}))
        return
    if only == "replay":
        # real-FILE replay smoke (dev): the committed PGM fixtures through
        # ImageFileReader → raw-depth conversion → full pipeline (the
        # reference's own validation workflow)
        from infinitam_tpu.config import tiny_test_settings
        from infinitam_tpu.engine.main_engine import MainEngine
        from infinitam_tpu.io.sources import ImageFileReader

        fix = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "fixtures", "replay")
        src = ImageFileReader(os.path.join(fix, "calib.txt"), "",
                              os.path.join(fix, "depth_%04i.pgm"))
        gt = np.load(os.path.join(fix, "gt_poses.npy"))
        img = (src.calib.intrinsics_d.height, src.calib.intrinsics_d.width)
        eng = MainEngine(tiny_test_settings(), src.calib, img)
        n = 0
        t0 = time.perf_counter()
        while src.has_more_images():
            depth, _rgb = src.get_images()
            eng.process_frame(raw_depth=depth)
            n += 1
        jax.block_until_ready(eng.tracking_state.pose)
        dt = time.perf_counter() - t0
        err = np.asarray(se3.se3_log(
            jnp.asarray(eng.get_pose()) @ se3.invert(jnp.asarray(gt[-1]))))
        print(json.dumps({"metric": "file replay smoke (dev)",
                          "value": round(n / dt, 2), "unit": "frames/s",
                          "vs_baseline": 1.0,
                          "t_err_mm": round(float(np.linalg.norm(err[:3])) * 1e3, 2),
                          "frames": n}))
        return
    if only == "color":
        settings = teddy_1cm_settings().replace(use_color=True)
        fps_c, ate_c, rot_c, diag_c = run_config(settings, with_color=True)
        print(f"diag(color): {diag_c}", file=sys.stderr)
        print(json.dumps({"metric": "fps @1cm+RGB fusion (dev)",
                          "value": round(fps_c, 2), "unit": "frames/s",
                          "vs_baseline": round(fps_c / 100, 3),
                          "ate_rmse_m": round(ate_c, 5),
                          "rot_rmse_deg": round(rot_c, 3)}))
        return
    if only == "1cm":
        fps_1cm, ate_1cm, rot_1cm, diag_1cm = run_config(teddy_1cm_settings())
        print(f"diag(1cm): {diag_1cm}", file=sys.stderr)
        print(json.dumps({"metric": "fps @1cm (dev)", "value": round(fps_1cm, 2),
                          "unit": "frames/s", "vs_baseline": round(fps_1cm / 100, 3),
                          "ate_rmse_m": round(ate_1cm, 5),
                          "rot_rmse_deg": round(rot_1cm, 3)}))
        return
    if only == "5mm":
        fps_ref, ate_ref, rot_ref, diag_ref = run_config(reference_settings())
        print(f"diag(5mm): {diag_ref}", file=sys.stderr)
        print(json.dumps({"metric": "fps @5mm (dev)", "value": round(fps_ref, 2),
                          "unit": "frames/s", "vs_baseline": round(fps_ref / 100, 3),
                          "ate_rmse_m": round(ate_ref, 5),
                          "rot_rmse_deg": round(rot_ref, 3)}))
        return
    fps_ref, ate_ref, rot_ref, diag_ref = run_config(reference_settings())
    print(f"diag(5mm): {diag_ref}", file=sys.stderr)
    fps_1cm, ate_1cm, rot_1cm, diag_1cm = run_config(teddy_1cm_settings())
    print(f"diag(1cm): {diag_1cm}", file=sys.stderr)
    fps_c, ate_c, _rot_c, diag_c = run_config(
        teddy_1cm_settings().replace(use_color=True), with_color=True
    )
    print(f"diag(1cm+rgb): {diag_c}", file=sys.stderr)
    swap_ratio, _fns, _fsw = run_swap_ratio()

    diverged = not (ate_ref < 0.01 and rot_ref < 1.0)
    print(
        json.dumps(
            {
                "metric": "fused+tracked 640x480 frames/s/chip @ reference 5mm/2cm"
                + (" (ATE>1cm or rot>1deg: FAILED)" if diverged else ""),
                "value": 0.0 if diverged else round(fps_ref, 2),
                "unit": "frames/s",
                "vs_baseline": 0.0 if diverged else round(fps_ref / 100.0, 3),
                "ate_rmse_m": round(ate_ref, 5),
                "rot_rmse_deg": round(rot_ref, 3),
                "fps_1cm_voxel": round(fps_1cm, 2),
                "ate_rmse_1cm_m": round(ate_1cm, 5),
                "rot_rmse_1cm_deg": round(rot_1cm, 3),
                "fps_1cm_rgb_fusion": round(fps_c, 2),
                "ate_rmse_rgb_m": round(ate_c, 5),
                "swap_fps_ratio": round(swap_ratio, 3),
            }
        )
    )


if __name__ == "__main__":
    main()
