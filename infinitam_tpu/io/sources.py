"""Frame sources: dataset readers with the reference's pull interface.

Reference parity: InfiniTAM/Engine/ImageSourceEngine.{h,cpp} —
ImageSourceEngine (calib + hasMoreImages/getImages), ImageFileReader
(printf-mask ppm/pgm sequences with a one-frame cache), RawFileReader,
CalibSource; Engine/IMUSourceEngine.cpp (per-frame 3×3 rotation text files).
Plus a TUM-RGBD association-file reader (the reference's users feed TUM
sequences through the same mask mechanism).

Live camera sources (OpenNI/UVC/RealSense/Kinect2, reference
Engine/OpenNIEngine.cpp etc.) have no hardware in this environment and are
represented by the `LiveSourceStub` gate.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from infinitam_tpu.calib import RGBDCalib, default_calib, read_rgbd_calib
from infinitam_tpu.utils.image_io import expand_printf_mask, read_image


class ImageSourceEngine:
    """Abstract pull-style source (reference: ImageSourceEngine.h:9-21)."""

    calib: RGBDCalib

    def has_more_images(self) -> bool:
        raise NotImplementedError

    def get_images(self) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
        """Returns (raw_depth uint16 [H,W], rgb uint8 [H,W,3] or None)."""
        raise NotImplementedError


class CalibSource(ImageSourceEngine):
    """Calibration only, no frames (reference: CalibSource — used when a live
    source provides images but calib comes from file)."""

    def __init__(self, calib_path: str):
        self.calib = read_rgbd_calib(calib_path)

    def has_more_images(self) -> bool:
        return False

    def get_images(self):
        raise RuntimeError("CalibSource provides no images")


class ImageFileReader(ImageSourceEngine):
    """printf-mask sequence reader (reference: ImageFileReader — masks like
    `Frames/%04i.ppm` / `%04i.pgm`, caching one frame ahead)."""

    def __init__(self, calib_path: str, rgb_mask: str, depth_mask: str, start_index: int = 0):
        self.calib = read_rgbd_calib(calib_path)
        self.rgb_mask = rgb_mask
        self.depth_mask = depth_mask
        self.index = start_index
        self._cached: Optional[Tuple[np.ndarray, Optional[np.ndarray]]] = None
        self._cache_index = -1

    def _paths(self, i: int):
        return (
            expand_printf_mask(self.rgb_mask, i) if self.rgb_mask else None,
            expand_printf_mask(self.depth_mask, i),
        )

    def _load(self, i: int):
        rgb_path, depth_path = self._paths(i)
        if not os.path.exists(depth_path):
            return None
        depth = read_image(depth_path)
        rgb = None
        if rgb_path and os.path.exists(rgb_path):
            rgb = read_image(rgb_path)
        return depth, rgb

    def has_more_images(self) -> bool:
        if self._cache_index != self.index:
            self._cached = self._load(self.index)
            self._cache_index = self.index
        return self._cached is not None

    def get_images(self):
        if not self.has_more_images():
            raise StopIteration
        depth, rgb = self._cached
        self.index += 1
        return depth, rgb


class RawFileReader(ImageSourceEngine):
    """Raw binary frame reader (reference: RawFileReader — fixed-size
    uint16 depth + rgb frames appended per index)."""

    def __init__(self, calib_path: str, rgb_mask: str, depth_mask: str, image_size: Tuple[int, int]):
        self.calib = read_rgbd_calib(calib_path)
        self.rgb_mask = rgb_mask
        self.depth_mask = depth_mask
        self.image_size = image_size  # (H, W)
        self.index = 0

    def has_more_images(self) -> bool:
        return os.path.exists(expand_printf_mask(self.depth_mask, self.index))

    def get_images(self):
        H, W = self.image_size
        dpath = expand_printf_mask(self.depth_mask, self.index)
        depth = np.fromfile(dpath, dtype=np.uint16, count=H * W).reshape(H, W)
        rgb = None
        if self.rgb_mask:
            rpath = expand_printf_mask(self.rgb_mask, self.index)
            if os.path.exists(rpath):
                rgb = np.fromfile(rpath, dtype=np.uint8, count=H * W * 3).reshape(H, W, 3)
        self.index += 1
        return depth, rgb


class TUMSource(ImageSourceEngine):
    """TUM-RGBD sequence via an associations file (`timestamp rgb_path
    timestamp depth_path` per line). Depth PNGs are 16-bit with 1/5000 m
    scale; calib defaults to the TUM fr intrinsics unless given."""

    TUM_DEPTH_SCALE = 1.0 / 5000.0

    def __init__(self, root: str, associations: str = "associations.txt", calib: Optional[RGBDCalib] = None):
        self.root = root
        self.pairs = []
        with open(os.path.join(root, associations)) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                if len(parts) >= 4:
                    self.pairs.append((parts[1], parts[3]))
        if calib is None:
            from infinitam_tpu.calib import DisparityCalib, Intrinsics

            intr = Intrinsics(fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=640, height=480)
            calib = default_calib(640, 480)
            calib = RGBDCalib(
                intrinsics_rgb=intr,
                intrinsics_d=intr,
                trafo_rgb_to_depth=calib.trafo_rgb_to_depth,
                disparity=DisparityCalib(a=self.TUM_DEPTH_SCALE, b=0.0, type="affine"),
            )
        self.calib = calib
        self.index = 0

    def has_more_images(self) -> bool:
        return self.index < len(self.pairs)

    def get_images(self):
        rgb_rel, depth_rel = self.pairs[self.index]
        self.index += 1
        depth = read_image(os.path.join(self.root, depth_rel))
        rgb = read_image(os.path.join(self.root, rgb_rel))
        return depth, rgb


class IMUSource:
    """Per-frame 3×3 rotation matrices from text files (reference:
    IMUSourceEngine.cpp:11-69 — nine floats per file, printf mask)."""

    def __init__(self, mask: str):
        self.mask = mask
        self.index = 0

    def has_more_measurements(self) -> bool:
        return os.path.exists(expand_printf_mask(self.mask, self.index))

    def get_measurement(self) -> np.ndarray:
        path = expand_printf_mask(self.mask, self.index)
        self.index += 1
        vals = np.loadtxt(path).reshape(3, 3).astype(np.float32)
        return vals


class PoseSource:
    """External pose feed (reference: PoseSourceEngine / RosPoseSourceEngine
    without ROS — poses pushed by the caller, pulled per frame)."""

    def __init__(self):
        self._pose: Optional[np.ndarray] = None

    def push(self, pose_4x4: np.ndarray) -> None:
        self._pose = np.asarray(pose_4x4, dtype=np.float32)

    def latest(self) -> Optional[np.ndarray]:
        return self._pose


class RecordingSource(ImageSourceEngine):
    """Wrap any source and record its raw stream to disk for deterministic
    replay (reference: UIEngine 's' key writes the input depth/rgb images to
    Files/Out with printf masks, UIEngine.cpp:498-508). Replay the directory
    later with `replay_source(dir)` / `--replay`."""

    DEPTH_MASK = "depth_%04i.pgm"
    RGB_MASK = "rgb_%04i.ppm"

    def __init__(self, inner: ImageSourceEngine, out_dir: str):
        from infinitam_tpu.utils.image_io import write_image

        self._write = write_image
        self.inner = inner
        self.calib = inner.calib
        self.out_dir = out_dir
        self.index = 0
        os.makedirs(out_dir, exist_ok=True)

    def has_more_images(self) -> bool:
        return self.inner.has_more_images()

    def get_images(self):
        out = self.inner.get_images()
        depth, rgb = out[0], out[1]
        if depth is not None:
            d = np.asarray(depth)
            if d.dtype != np.uint16:
                # metric float depth records as millimetres (TUM-style raw)
                d = np.clip(np.asarray(d, np.float64) * 1000.0, 0, 65535).astype(np.uint16)
            self._write(
                os.path.join(self.out_dir, expand_printf_mask(self.DEPTH_MASK, self.index)), d
            )
        if rgb is not None:
            r = np.asarray(rgb)
            if r.dtype != np.uint8:
                r = np.clip(np.asarray(r, np.float64) * 255.0, 0, 255).astype(np.uint8)
            self._write(
                os.path.join(self.out_dir, expand_printf_mask(self.RGB_MASK, self.index)), r
            )
        self.index += 1
        return out


class ReplaySource(ImageSourceEngine):
    """Replay a RecordingSource directory (metric depth reconstructed from
    the recorded millimetre uint16)."""

    def __init__(self, rec_dir: str, calib: RGBDCalib):
        self.root = rec_dir
        self.calib = calib
        self.index = 0

    def _dpath(self, i: int) -> str:
        return os.path.join(self.root, expand_printf_mask(RecordingSource.DEPTH_MASK, i))

    def has_more_images(self) -> bool:
        return os.path.exists(self._dpath(self.index))

    def get_images(self):
        depth_mm = read_image(self._dpath(self.index))
        rpath = os.path.join(
            self.root, expand_printf_mask(RecordingSource.RGB_MASK, self.index)
        )
        rgb = read_image(rpath) if os.path.exists(rpath) else None
        self.index += 1
        return depth_mm.astype(np.float32) / 1000.0, rgb


def make_source(
    calib_path: Optional[str] = None,
    rgb_mask: Optional[str] = None,
    depth_mask: Optional[str] = None,
    tum_root: Optional[str] = None,
    allow_synthetic: bool = True,
    img_size: Tuple[int, int] = (480, 640),
    n_frames: int = 50,
    with_rgb: bool = False,
):
    """Source fallback chain (reference: InfiniTAM.cpp:21-87 tries
    files → OpenNI → UVC → RealSense → Kinect2): here
    file masks → TUM directory → live cameras (absent in this build) →
    synthetic replay. Returns (source, is_synthetic)."""
    if depth_mask and calib_path:
        first = expand_printf_mask(depth_mask, 0)
        if os.path.exists(first):
            return ImageFileReader(calib_path, rgb_mask or "", depth_mask), False
        print(f"[sources] no frames at {first}; trying next source")
    if tum_root and os.path.exists(os.path.join(tum_root, "associations.txt")):
        return TUMSource(tum_root), False
    try:
        return LiveSourceStub(), False
    except RuntimeError as e:
        print(f"[sources] {e}")
    if not allow_synthetic:
        raise RuntimeError("no usable image source")
    from infinitam_tpu.io import synth

    calib = (
        read_rgbd_calib(calib_path) if calib_path
        else default_calib(img_size[1], img_size[0])
    )
    return (
        synth.SyntheticSource(calib, n_frames=n_frames, img_size=img_size, with_rgb=with_rgb),
        True,
    )


class LiveSourceStub(ImageSourceEngine):
    """Placeholder for live camera backends (OpenNI2 / libuvc / RealSense /
    Kinect2 — reference Engine/{OpenNIEngine,LibUVCEngine,RealSenseEngine,
    Kinect2Engine}.cpp). No camera hardware exists in this deployment; the
    class preserves the fallback-chain API of InfiniTAM.cpp:21-87."""

    def __init__(self, *_a, **_k):
        raise RuntimeError(
            "live camera sources are unavailable in this build; use "
            "ImageFileReader/TUMSource/SyntheticSource"
        )


class DeviceFrameFeed(ImageSourceEngine):
    """Device-side frame ring buffer (SURVEY §7 swap-latency hiding applied
    to input — the live-pipeline feed the bench's scan replay models). Wraps
    any source and keeps the next `depth_frames` frames UPLOADED ahead of
    the consumer: `jax.device_put` is asynchronous, so frame k+1's H2D
    transfer rides under frame k's device compute instead of serializing
    the live loop."""

    def __init__(self, inner: ImageSourceEngine, depth_frames: int = 3):
        self.inner = inner
        self.calib = inner.calib
        self.depth_frames = depth_frames
        self._q: list = []

    def _fill(self) -> None:
        import jax
        import jax.numpy as jnp

        while len(self._q) < self.depth_frames and self.inner.has_more_images():
            out = self.inner.get_images()
            dev = tuple(
                None if a is None else jax.device_put(jnp.asarray(a))
                for a in out[:2]
            )
            self._q.append(dev + tuple(out[2:]))

    def has_more_images(self) -> bool:
        self._fill()
        return len(self._q) > 0

    def get_images(self):
        self._fill()
        if not self._q:
            raise StopIteration
        return self._q.pop(0)
