"""Entry points: chip_smoke.py's contract, the compile-cache rule, float32
precision of every product in the frame program, and the multi-device dry
run's refusal to fall back to fewer devices."""

import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
from jax.extend import core as jcore

import __graft_entry__ as graft
import bench
import chip_smoke
from infinitam_tpu.utils import compile_cache, se3

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chip_smoke_device_check_raises_on_cpu():
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        chip_smoke.require_gpu()


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "script_alone"])
def test_chip_smoke_fails_without_gpu_and_prints_no_result(tmp_path, alone):
    """On a CPU backend — and in a directory holding only the script — the
    run exits non-zero and prints no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    out = subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_last_line_format():
    dev = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    line = chip_smoke.result_line([dev])
    assert line == (
        '{"ok": true, "device": {"platform": "gpu", '
        '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}'
    )
    assert json.loads(chip_smoke.result_line([dev] * 4))["device"]["count"] == 4


def test_chip_smoke_four_selects_only_its_phase():
    assert chip_smoke.phases(True) == ["four"]
    single = chip_smoke.phases(False)
    assert "four" not in single
    assert single == ["engine_5mm", "replay_5mm", "color_1cm", "swap_1cm", "raycast_kernel"]


def test_pose_gap_and_rotation_metric():
    a = [np.eye(4)] * 3
    R = np.asarray(se3.se3_exp(np.array([0.0, 0.003, 0.0, 0.0, 0.0, np.radians(1.0)])))
    assert chip_smoke.pose_gap(a, a) == (0.0, 0.0)
    dt, dr = chip_smoke.pose_gap(a, [np.eye(4), np.eye(4), R])
    assert abs(dr - 1.0) < 1e-4 and 0.002 < dt < 0.004
    assert bench.rotation_angle_deg(np.eye(3)) == 0.0


def test_compile_cache_uses_env_dir_and_sets_no_other(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # left to JAX


def test_compile_cache_default_is_fixed_and_ignored(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = compile_cache.enable_compile_cache()
        assert path == compile_cache.DEFAULT_DIR == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def _dots(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for v in eqn.params.values():
            for sub in v if isinstance(v, (list, tuple)) else [v]:
                if isinstance(sub, jcore.ClosedJaxpr):
                    yield from _dots(sub.jaxpr)
                elif isinstance(sub, jcore.Jaxpr):
                    yield from _dots(sub)


def test_frame_program_products_are_full_float32():
    """With no global matmul-precision flag, every dot_general in the frame
    program asks for HIGHEST (a GPU would otherwise run them in TF32)."""
    assert jax.config.jax_default_matmul_precision is None
    fn, args = graft.entry()
    dots = list(_dots(jax.make_jaxpr(fn)(*args).jaxpr))
    assert len(dots) >= 6  # at least the normal equations of each ICP level
    hi = jax.lax.Precision.HIGHEST
    low = [e for e in dots if e.params["precision"] not in ((hi, hi), hi)]
    assert not low, f"{len(low)} products at default precision: {low[0]}"


def test_dryrun_multichip_refuses_too_few_devices():
    n = len(jax.devices())
    with pytest.raises(RuntimeError, match=f"needs {n + 1} devices, found {n}"):
        graft.dryrun_multichip(n + 1)
