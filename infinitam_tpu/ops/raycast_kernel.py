"""Sphere-tracing raycast as a Pallas kernel on the Triton route (NVIDIA GPUs).

One program marches one tile of TILE rays with a while loop of its own: a ray
stops at its surface or range end, and the program stops with its last ray
(reference: genericRaycast_device, one CUDA thread per pixel running castRay,
DeviceAgnostic/ITMVisualisationEngine.h:92-158). Voxel reads are masked
gathers: the dense block→VBA-pointer grid (hash_volume.build_block_grid),
then the packed voxel row. The step rule, the empty-space DDA clamp and the
secant + two trilinear refinements are those of ops/raycast.raycast_rays,
which stays the plain reference that the tests compare against.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from infinitam_tpu.engine.hash_volume import SDF_SCALE

TILE = 128  # rays per program (one per thread at 4 warps)


def _read_sdf(grid_ref, vox_ref, ix, iy, iz, dims, origin, block_size):
    """(sdf, found) at int voxel coords: grid tap → packed voxel tap. Empty
    space reads sdf = 1 (reference readVoxel)."""
    gx, gy, gz = dims
    sh = block_size.bit_length() - 1
    m = block_size - 1
    bx = (ix >> sh) - origin[0]
    by = (iy >> sh) - origin[1]
    bz = (iz >> sh) - origin[2]
    inb = (bx >= 0) & (bx < gx) & (by >= 0) & (by < gy) & (bz >= 0) & (bz < gz)
    cell = jnp.where(inb, (bx * gy + by) * gz + bz, 0)
    ptr = plgpu.load(grid_ref.at[cell], mask=inb, other=-1)
    found = inb & (ptr >= 0)
    lin = (ix & m) + (iy & m) * block_size + (iz & m) * (block_size * block_size)
    off = jnp.where(found, ptr, 0) * (block_size**3) + lin
    v = plgpu.load(vox_ref.at[off], mask=found, other=0)
    sdf = (v >> 16).astype(jnp.float32) * (1.0 / SDF_SCALE)
    return jnp.where(found, sdf, 1.0), found


def _read_trilinear(read, px, py, pz):
    """Trilinear SDF over the 8 surrounding voxels (same corner order and
    blend as voxel_access.read_sdf_interpolated)."""
    bx, by, bz = jnp.floor(px), jnp.floor(py), jnp.floor(pz)
    cx, cy, cz = px - bx, py - by, pz - bz
    ix, iy, iz = bx.astype(jnp.int32), by.astype(jnp.int32), bz.astype(jnp.int32)

    def rv(dx, dy, dz):
        return read(ix + dx, iy + dy, iz + dz)[0]

    r00 = (1 - cx) * rv(0, 0, 0) + cx * rv(1, 0, 0)
    r10 = (1 - cx) * rv(0, 1, 0) + cx * rv(1, 1, 0)
    r01 = (1 - cx) * rv(0, 0, 1) + cx * rv(1, 0, 1)
    r11 = (1 - cx) * rv(0, 1, 1) + cx * rv(1, 1, 1)
    r0 = (1 - cy) * r00 + cy * r10
    r1 = (1 - cy) * r01 + cy * r11
    return (1 - cz) * r0 + cz * r1


def _kernel(
    sx_ref, sy_ref, sz_ref, dx_ref, dy_ref, dz_ref, l0_ref, l1_ref,
    grid_ref, vox_ref,
    ox_ref, oy_ref, oz_ref, ow_ref,
    *, step_scale, dims, origin, block_size,
):
    read = partial(
        _read_sdf, grid_ref, vox_ref, dims=dims, origin=origin,
        block_size=block_size,
    )
    d = (dx_ref[...], dy_ref[...], dz_ref[...])
    len_end = l1_ref[...]
    bs = float(block_size)

    def body(c):
        px, py, pz, total, sdf_prev, active = c
        sdf, found = read(
            jnp.floor(px + 0.5).astype(jnp.int32),
            jnp.floor(py + 0.5).astype(jnp.int32),
            jnp.floor(pz + 0.5).astype(jnp.int32),
        )
        hit = found & (sdf <= 0.0)
        # distance to the current block's exit along the ray (DDA clamp)
        t_exit = None
        for p, di in zip((px, py, pz), d):
            bound = (jnp.floor(p / bs) + jnp.where(di > 0, 1.0, 0.0)) * bs
            tiny = jnp.abs(di) < 1e-9
            t = jnp.where(tiny, 1e9, (bound - p) / jnp.where(tiny, 1e-9, di))
            t_exit = t if t_exit is None else jnp.minimum(t_exit, t)
        empty_step = jnp.clip(t_exit + 0.01, 0.5, bs)
        step = jnp.where(found, jnp.maximum(sdf * step_scale, 1.0), empty_step)
        act = active > 0
        adv = act & ~hit
        px = jnp.where(adv, px + step * d[0], px)
        py = jnp.where(adv, py + step * d[1], py)
        pz = jnp.where(adv, pz + step * d[2], pz)
        total = jnp.where(adv, total + step, total)
        new_active = (adv & (total < len_end)).astype(jnp.int32)
        return px, py, pz, total, jnp.where(act, sdf, sdf_prev), new_active

    init = (
        sx_ref[...], sy_ref[...], sz_ref[...], l0_ref[...],
        jnp.ones((TILE,), jnp.float32), jnp.ones((TILE,), jnp.int32),
    )
    px, py, pz, _total, sdf, _a = jax.lax.while_loop(
        lambda c: jnp.max(c[5]) > 0, body, init
    )

    found_surface = sdf <= 0.0
    qx = px + sdf * step_scale * d[0]
    qy = py + sdf * step_scale * d[1]
    qz = pz + sdf * step_scale * d[2]
    for _ in range(2):
        s = _read_trilinear(read, qx, qy, qz) * step_scale
        qx, qy, qz = qx + s * d[0], qy + s * d[1], qz + s * d[2]
    ox_ref[...] = jnp.where(found_surface, qx, px)
    oy_ref[...] = jnp.where(found_surface, qy, py)
    oz_ref[...] = jnp.where(found_surface, qz, pz)
    ow_ref[...] = jnp.where(found_surface, 1.0, 0.0)


def raycast_grid(
    pt_start: jnp.ndarray,  # [..., 3] voxel units
    ray_dir: jnp.ndarray,  # [..., 3] unit
    len_start: jnp.ndarray,  # [...]
    len_end: jnp.ndarray,  # [...]
    grid: jnp.ndarray,  # block→VBA-pointer grid, any shape of G³ int32
    vox: jnp.ndarray,  # [B, S³] packed voxels
    step_scale: float,  # mu / voxel_size
    grid_dims: Tuple[int, int, int],
    grid_origin: Tuple[int, int, int],
    block_size: int = 8,
    interpret: bool = False,
) -> jnp.ndarray:
    """Kernel counterpart of raycast.raycast_rays over a grid reader →
    [..., 4] (hit position in voxel units, w = hit flag)."""
    if block_size & (block_size - 1):
        raise ValueError(f"block_size must be a power of 2, got {block_size}")
    shape = len_start.shape
    n = len_start.size
    npad = -(-n // TILE) * TILE

    def plane(a):
        return jnp.pad(a.reshape(n).astype(jnp.float32), (0, npad - n))

    ins = [plane(pt_start[..., k]) for k in range(3)]
    ins += [plane(ray_dir[..., k]) for k in range(3)]
    ins += [plane(len_start), plane(len_end)]
    tile = pl.BlockSpec((TILE,), lambda i: (i,))
    whole = pl.BlockSpec()  # gathered from: the whole array, no tiling
    out = pl.pallas_call(
        partial(
            _kernel, step_scale=float(step_scale), dims=tuple(grid_dims),
            origin=tuple(grid_origin), block_size=block_size,
        ),
        out_shape=[jax.ShapeDtypeStruct((npad,), jnp.float32)] * 4,
        grid=(npad // TILE,),
        in_specs=[tile] * 8 + [whole, whole],
        out_specs=[tile] * 4,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="raycast_grid",
    )(*ins, grid.reshape(-1), vox.reshape(-1))
    return jnp.stack([o[:n].reshape(shape) for o in out], axis=-1)
