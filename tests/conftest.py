"""Test configuration: force JAX onto a virtual 8-device CPU mesh.

All math runs on the CPU here, against the plain references (SURVEY.md §4);
sharding tests get 8 virtual devices via --xla_force_host_platform_device_count.
MUST run before jax is imported anywhere.

Tests that need the GPU are marked `gpu` and skip on the CPU with a reason; run
them on the card with `JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu`
(chip_smoke.py runs the same checks at full width).
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

from infinitam_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

jax.config.update("jax_enable_x64", False)
# Persistent compilation cache: recompiling the pipeline dominates test time
# otherwise.
enable_compile_cache()


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: runs only on an NVIDIA GPU")


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at test time, not
    at import, so every xdist worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda pytest -m gpu)")
