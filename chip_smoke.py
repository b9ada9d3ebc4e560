"""Smoke run of the hash-volume SLAM frame on one NVIDIA GPU.

    python chip_smoke.py          # phases a-f on one card
    python chip_smoke.py --four   # sequences batched over four cards, and
                                  # each lane alone on one card

Drives the allocate → integrate → raycast → track frame through the entry
points a user calls (`MainEngine.process_frame` and the scan replay
`hash_pipeline.process_sequence_hash`) at full width: 640×480 frames of the
seeded synthetic sequence (io/synth.py), the reference's 5 mm / 2 cm
operating point and capacities. Every phase checks its result and any failure
ends the run with a non-zero exit code. The last line of standard output is
one JSON object naming the device; it is printed only when every phase
passed. The script needs a GPU and refuses to run without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

# stated tolerances between two runs of the same frames through different
# programs (float sums differ in order; the tracker converges to the same
# minimum each frame)
POSE_TOL_M = 2e-3
POSE_TOL_DEG = 0.2
ATE_MAX_M = 0.01  # BASELINE.md accuracy bar, as bench.py gates it
ROT_MAX_DEG = 1.0
N_FRAMES = 30
N_FRAMES_FOUR = 10


def require_gpu() -> None:
    """Phase a: JAX must run on a GPU. No fallback to another backend."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(
            f"chip_smoke needs an NVIDIA GPU; JAX's default backend is {backend!r}"
        )


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


def result_line(devices) -> str:
    """The final JSON line: the device as JAX reports it."""
    d = devices[0]
    return json.dumps(
        {"ok": True, "device": {
            "platform": d.platform, "kind": d.device_kind, "count": len(devices),
        }}
    )


def phases(four: bool) -> list:
    """Phase names in run order: --four runs its own phase and nothing else."""
    if four:
        return ["four"]
    return ["engine_5mm", "replay_5mm", "color_1cm", "swap_1cm", "raycast_kernel"]


def log(msg: str) -> None:
    print(msg, flush=True)


class SmokeFailure(AssertionError):
    """A phase's result is wrong; the run ends with a non-zero exit code."""


def check(ok, msg: str) -> None:
    """A check that stays under `python -O` (unlike assert)."""
    if not ok:
        raise SmokeFailure(msg)


def _frames(settings, img, n, with_rgb=False, scale=None):
    """(calib, [(depth, rgb, gt)]) of the seeded synthetic sequence."""
    from infinitam_tpu.calib import default_calib
    from infinitam_tpu.config import assert_alloc_stride_safe
    from infinitam_tpu.io import synth

    calib = default_calib(img[1], img[0])
    assert_alloc_stride_safe(settings, calib.intrinsics_d.fx)
    src = synth.SyntheticSource(calib, n_frames=n, img_size=img, with_rgb=with_rgb)
    if scale is not None:
        src.gt_poses = synth.make_trajectory(n, scale=scale)
    return calib, [src.get_images() for _ in range(n)]


def _check_accuracy(tag, poses, frames, diags) -> dict:
    """ATE / rotation gates and the max of every silent-cap counter."""
    import numpy as np

    from bench import CAP_COUNTERS, trajectory_errors

    ate, rot = trajectory_errors(poses, [gt for _d, _r, gt in frames])
    caps = {k: int(np.max(np.asarray(getattr(diags, k)))) for k in CAP_COUNTERS}
    log(f"[{tag}] ATE {ate * 1e3:.3f} mm, rotation RMSE {rot:.4f} deg, "
        f"max caps {caps}")
    check(ate <= ATE_MAX_M, f"{tag}: ATE {ate:.4f} m > {ATE_MAX_M}")
    check(rot <= ROT_MAX_DEG, f"{tag}: rotation RMSE {rot:.3f} deg > {ROT_MAX_DEG}")
    check(all(v == 0 for v in caps.values()), f"{tag}: silent caps hit: {caps}")
    return {"ate_m": ate, "rot_deg": rot, **caps}


def pose_gap(a, b) -> tuple:
    """(max camera-centre distance in m, max rotation angle in deg) between
    two pose sequences."""
    import numpy as np

    from bench import rotation_angle_deg

    dt, dr = 0.0, 0.0
    for pa, pb in zip(a, b):
        pa = np.asarray(pa, np.float64)
        pb = np.asarray(pb, np.float64)
        ca = np.linalg.inv(pa)[:3, 3]
        cb = np.linalg.inv(pb)[:3, 3]
        dt = max(dt, float(np.linalg.norm(ca - cb)))
        dr = max(dr, rotation_angle_deg(pa[:3, :3] @ pb[:3, :3].T))
    return dt, dr


def _check_same_poses(tag, a, b) -> None:
    dt, dr = pose_gap(a, b)
    log(f"[{tag}] max pose gap {dt * 1e3:.4f} mm / {dr:.5f} deg "
        f"(tolerance {POSE_TOL_M * 1e3:.1f} mm / {POSE_TOL_DEG} deg)")
    check(dt <= POSE_TOL_M and dr <= POSE_TOL_DEG, f"{tag}: poses disagree")


def run_engine(settings, img, n, tag, scale=None):
    """Frame-at-a-time through MainEngine.process_frame. Returns (poses,
    stacked diagnostics, engine, frames)."""
    import jax
    import numpy as np

    from infinitam_tpu.engine.main_engine import MainEngine

    calib, frames = _frames(settings, img, n, scale=scale)
    eng = MainEngine(settings, calib, img)
    poses, diags, times = [], [], []
    for depth, _rgb, _gt in frames:
        t0 = time.perf_counter()
        d = eng.process_frame(metric_depth=depth)
        jax.block_until_ready(eng.tracking_state.pose)
        times.append(time.perf_counter() - t0)
        poses.append(np.asarray(eng.tracking_state.pose))
        diags.append(d.device)
    diags = jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *diags)
    log(f"[{tag}] set-up (first frame, compile included) {times[0]:.2f} s")
    log(f"[{tag}] steady {1e3 * float(np.median(times[2:])):.3f} ms/frame "
        f"(median of frames 2-{n - 1}, synced every frame)")
    return np.stack(poses), diags, eng, frames


def run_replay(settings, img, n, tag, with_rgb=False):
    """The scan replay: compile + first run, then a timed rerun from a fresh
    map. Returns (poses, diags, frames)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from infinitam_tpu.engine import hash_pipeline as hp

    calib, frames = _frames(settings, img, n, with_rgb=with_rgb)
    depths = jnp.stack([d for d, _r, _g in frames])
    kw = {}
    if with_rgb:
        kw = dict(
            rgbs=jnp.stack([r for _d, r, _g in frames]),
            proj_rgb=jnp.asarray(calib.intrinsics_rgb.vector),
            rgb_to_depth=jnp.asarray(calib.rgb_to_depth),
        )
    proj = jnp.asarray(calib.intrinsics_d.vector)
    out = None
    for run in range(2):
        vol, rs, state = hp.create_engine_state(settings, img)
        jax.block_until_ready(vol.vox)
        t0 = time.perf_counter()
        out = hp.process_sequence_hash(vol, rs, state, depths, proj, settings, **kw)
        jax.block_until_ready(out[3])
        dt = time.perf_counter() - t0
        if run == 0:
            log(f"[{tag}] set-up (compile + first replay) {dt:.2f} s")
        else:
            log(f"[{tag}] steady {1e3 * dt / n:.3f} ms/frame "
                f"({n} frames in one scan program)")
    return np.asarray(out[3]), out[4], frames


def phase_engine_5mm(settings, img, n=N_FRAMES):
    """Phase b: the reference operating point through MainEngine."""
    poses, diags, eng, frames = run_engine(settings, img, n, "b engine 5mm")
    _check_accuracy("b engine 5mm", poses, frames, diags)
    return poses, eng


def phase_replay_5mm(settings, img, engine_poses, n=N_FRAMES):
    """Phase c: the same frames through the scan replay; poses must match
    phase b's."""
    poses, diags, frames = run_replay(settings, img, n, "c replay 5mm")
    _check_accuracy("c replay 5mm", poses, frames, diags)
    _check_same_poses("c replay vs engine", poses, engine_poses)


def phase_color_1cm(settings, img, n=N_FRAMES):
    """Phase d: 1 cm with RGB fusion (the colour integrate path)."""
    poses, diags, frames = run_replay(settings, img, n, "d color 1cm", with_rgb=True)
    _check_accuracy("d color 1cm", poses, frames, diags)


def phase_swap_1cm(settings, img, n=N_FRAMES):
    """Phase e: SwappingMode.ENABLED through MainEngine (SwapExchange and
    its async host copies) against the same frames without swapping."""
    from infinitam_tpu.config import SwappingMode

    ref, diags, _e, frames = run_engine(settings, img, n, "e engine 1cm")
    _check_accuracy("e engine 1cm", ref, frames, diags)
    sw_settings = settings.replace(swapping_mode=SwappingMode.ENABLED)
    poses, diags, eng, _f = run_engine(sw_settings, img, n, "e swap 1cm")
    _check_accuracy("e swap 1cm", poses, frames, diags)
    _check_same_poses("e swap vs no-swap", poses, ref)
    eng.flush_swap()


def phase_raycast_kernel(eng, interpret=False, reps=20):
    """Phase f: the Triton raycast against the XLA march on the same rays,
    from the last tracked pose of a fused map."""
    import jax
    import numpy as np

    from infinitam_tpu.engine import hash_pipeline as hp
    from infinitam_tpu.engine import hash_volume as hv
    from infinitam_tpu.ops import raycast as rc
    from infinitam_tpu.ops import raycast_kernel as rk
    from infinitam_tpu.utils import se3

    s = eng.settings
    sp, hpar, gp = s.scene, s.hashing, s.block_grid
    vol, rs, img = eng.vol, eng.render_state, eng.img_size
    pose = eng.tracking_state.pose
    step_scale = sp.mu / sp.voxel_size

    @jax.jit
    def rays(vol, rs, pose):
        zmin, zmax, _ = hp.expected_depth_ranges(vol, rs, pose, eng.proj, img, s)
        return rc.pixel_rays(
            se3.invert(pose), eng.proj, img, 1.0 / sp.voxel_size, zmin, zmax
        )

    @jax.jit
    def kernel(r, vol):
        grid = hv.get_block_grid(vol, gp, hpar)
        return rk.raycast_grid(
            *r, grid, vol.vox, step_scale, gp.dims, gp.origin, hpar.block_size,
            interpret=interpret,
        )

    @jax.jit
    def xla(r, vol):
        grid = hv.get_block_grid(vol, gp, hpar)
        read = hv.make_grid_reader(vol, grid, gp, hpar)
        return rc.raycast_rays(read, *r, step_scale, hpar.block_size)

    r = rays(vol, rs, pose)
    out = {}
    for name, fn in (("kernel", kernel), ("xla", xla)):
        res = jax.block_until_ready(fn(r, vol))
        t0 = time.perf_counter()
        for _ in range(reps):
            res = fn(r, vol)
        jax.block_until_ready(res)
        out[name] = np.asarray(res)
        log(f"[f raycast] {name}: {1e3 * (time.perf_counter() - t0) / reps:.3f} "
            f"ms per {img[1]}x{img[0]} raycast (mean of {reps}, alone)")
    fk, fx = out["kernel"][..., 3] > 0, out["xla"][..., 3] > 0
    agree = float(np.mean(fk == fx))
    both = fk & fx
    d = np.linalg.norm(out["kernel"][..., :3][both] - out["xla"][..., :3][both], axis=-1)
    log(f"[f raycast] hit agreement {agree:.6f}, {int(both.sum())} hits, "
        f"offset median {np.median(d):.2e} / max {d.max():.2e} voxels")
    check(both.sum() > 0.2 * fk.size, "f: too few hits for a fused map")
    check(agree >= 0.999, f"f: hit/miss agreement {agree}")
    check(np.median(d) < 1e-3 and np.percentile(d, 99) < 0.05, "f: hit offsets")
    check(np.isfinite(out["kernel"]).all(), "f: non-finite kernel output")


def phase_four(settings, img, n=N_FRAMES_FOUR, n_dev=4):
    """--four: B = n_dev sequences, each on its own trajectory, batched and
    sharded one lane per card; each lane's poses against the same lane run
    alone through MainEngine on one card."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from infinitam_tpu.calib import default_calib
    from infinitam_tpu.engine.view_builder import View
    from infinitam_tpu.io import synth
    from infinitam_tpu.parallel import batch as pb

    devs = jax.devices()
    check(len(devs) >= n_dev, f"--four needs {n_dev} devices, found {len(devs)}")
    calib = default_calib(img[1], img[0])
    proj = jnp.asarray(calib.intrinsics_d.vector)
    scales = [0.5 + 0.15 * b for b in range(n_dev)]
    trajs = [synth.make_trajectory(n, scale=sc) for sc in scales]

    mesh = pb.make_mesh(n_dev)
    vol, rs, state = pb.shard_batch(pb.batched_state_hash(settings, img, n_dev), mesh)
    spanned = {d for leaf in jax.tree.leaves(vol) for d in leaf.sharding.device_set}
    log(f"[four] state spans {len(spanned)} devices: "
        f"{sorted(str(d) for d in spanned)}")
    check(len(spanned) == n_dev, "batched state is not spread over every card")
    projs = pb.shard_batch(jnp.tile(proj[None], (n_dev, 1)), mesh)
    step = pb.make_batched_step(settings, mesh=mesh)
    poses = []
    t_set = None
    t0 = time.perf_counter()
    for f in range(n):
        depths = jnp.stack(
            [synth.render_depth(jnp.asarray(trajs[b][f]), proj, img) for b in range(n_dev)]
        )
        vol, rs, state, _m = step(vol, rs, state, pb.shard_batch(View(depth=depths), mesh), projs)
        poses.append(np.asarray(state.pose))
        if f == 0:
            t_set = time.perf_counter() - t0
            t0 = time.perf_counter()
    log(f"[four] set-up {t_set:.2f} s, steady {1e3 * (time.perf_counter() - t0) / (n - 1):.3f} "
        f"ms per batched frame ({n_dev} lanes)")
    out_spanned = {d for d in state.pose.sharding.device_set}
    check(len(out_spanned) == n_dev, "output poses are not spread over every card")
    poses = np.stack(poses, axis=1)  # [B, n, 4, 4]
    for b in range(n_dev):
        alone, diags, _e, frames = run_engine(settings, img, n, f"four lane {b} alone",
                                              scale=scales[b])
        _check_accuracy(f"four lane {b} alone", alone, frames, diags)
        _check_same_poses(f"four lane {b} sharded vs alone", poses[b], alone)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card batched path and its comparison")
    args = ap.parse_args(argv)

    import jax

    require_gpu()
    from infinitam_tpu.utils.compile_cache import enable_compile_cache

    log(f"[a device] compile cache: {enable_compile_cache()}")
    log(card_line())  # the card's name and power limit, as nvidia-smi gives them
    devices = jax.devices()
    log(f"[a device] jax {jax.__version__}: {len(devices)} x "
        f"{devices[0].device_kind} ({devices[0].platform})")

    import bench

    img = bench.IMG
    t_all = time.perf_counter()
    if args.four:
        phase_four(bench.teddy_1cm_settings(), img)
        devices = devices[:4]
    else:
        for name in phases(False):
            t0 = time.perf_counter()
            if name == "engine_5mm":
                poses_b, eng_b = phase_engine_5mm(bench.reference_settings(), img)
            elif name == "replay_5mm":
                phase_replay_5mm(bench.reference_settings(), img, poses_b)
            elif name == "color_1cm":
                phase_color_1cm(bench.teddy_1cm_settings().replace(use_color=True), img)
            elif name == "swap_1cm":
                phase_swap_1cm(bench.teddy_1cm_settings(), img)
            elif name == "raycast_kernel":
                phase_raycast_kernel(eng_b)
            log(f"[{name}] passed in {time.perf_counter() - t0:.1f} s")
        devices = devices[:1]
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
