"""Batched multi-sequence SLAM over a device mesh.

The reference is single-process single-GPU (SURVEY.md §2.7); the scale-out
axis here is the BATCH of independent RGB-D sequences: every state array
gets a leading [B] dim, the per-frame step is vmapped, and B is sharded over
a flat `jax.sharding.Mesh` data axis (one lane per GPU; NVLink joins the
cards of a host all to all, so the mesh needs no topology). Fleet
metrics (mean tracker energy/inliers) reduce across devices — XLA inserts the
all-reduce.

This replaces nothing in the reference (nothing distributed exists there) but
satisfies BASELINE.json's multi-host scaling configs.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from infinitam_tpu.config import Settings
from infinitam_tpu.engine import dense_pipeline as dp
from infinitam_tpu.engine import hash_pipeline as hp
from infinitam_tpu.engine import hash_volume as hv
from infinitam_tpu.engine.tracking_state import create_tracking_state
from infinitam_tpu.engine.view_builder import View


def make_mesh(n_devices: Optional[int] = None, axis: str = "data") -> Mesh:
    devs = jax.devices()[: n_devices or len(jax.devices())]
    return Mesh(devs, (axis,))


def batched_state_hash(settings: Settings, img_size: Tuple[int, int], batch: int):
    """[B]-leading engine state for `batch` independent sequences."""

    def one(_):
        vol = hv.create_hash(
            settings.hashing, with_color=settings.use_color, grid_params=settings.block_grid
        )
        rs = hv.create_render_state(settings.hashing, grid_params=settings.block_grid)
        st = create_tracking_state(img_size)
        return vol, rs, st

    return jax.vmap(one)(jnp.arange(batch))


def shard_batch(tree, mesh: Mesh, axis: str = "data"):
    """Place every leaf with its leading batch dim sharded over the mesh."""
    sharding = NamedSharding(mesh, P(axis))

    def put(x):
        return jax.device_put(x, sharding)

    return jax.tree_util.tree_map(put, tree)


def make_batched_step(settings: Settings, mesh: Optional[Mesh] = None, axis: str = "data"):
    """Jitted [B]-batched hash-pipeline frame step, optionally sharded.

    Returns step(vol, rs, state, view, proj) → (vol, rs, state, metrics);
    metrics are fleet-level scalars (mean over the batch → cross-device
    all-reduce when sharded).
    """

    def one_step(vol, rs, st, view, proj):
        return hp.process_frame_hash(vol, rs, st, view, proj, settings)

    vstep = jax.vmap(one_step)

    def step(vol, rs, st, view, proj):
        vol, rs, st, diag = vstep(vol, rs, st, view, proj)
        metrics = {
            "mean_f": jnp.mean(st.f),
            "mean_valid": jnp.mean(st.num_valid.astype(jnp.float32)),
            "total_visible": jnp.sum(diag.n_visible),
        }
        return vol, rs, st, metrics

    if mesh is None:
        return jax.jit(step)
    shard = NamedSharding(mesh, P(axis))
    replicated = NamedSharding(mesh, P())
    return jax.jit(
        step,
        in_shardings=(shard, shard, shard, shard, shard),
        out_shardings=(shard, shard, shard, replicated),
    )


def make_batched_step_dense(settings: Settings, mesh: Optional[Mesh] = None, axis: str = "data"):
    """Dense-volume variant (plain voxel array) of the batched step."""

    def one_step(vol, st, view, proj):
        return dp.process_frame_dense(vol, st, view, proj, settings)

    vstep = jax.vmap(one_step)

    def step(vol, st, view, proj):
        vol, st, diag = vstep(vol, st, view, proj)
        metrics = {"mean_f": jnp.mean(st.f), "mean_valid": jnp.mean(st.num_valid.astype(jnp.float32))}
        return vol, st, metrics

    if mesh is None:
        return jax.jit(step)
    shard = NamedSharding(mesh, P(axis))
    replicated = NamedSharding(mesh, P())
    return jax.jit(
        step,
        in_shardings=(shard, shard, shard, shard),
        out_shardings=(shard, shard, replicated),
    )
