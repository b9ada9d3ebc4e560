"""Voxel-block-hash world model: SoA hash table + block array.

Reference parity: ITMLib/Objects/ITMVoxelBlockHash.h:22 (2^20 ordered buckets
+ excess chain entries), ITMLocalVBA.h:19 (block storage + free list), and the
allocation protocol of ITMSceneReconstructionEngine_CUDA.cu:350-495
(buildHashAllocAndVisibleType → allocateVoxelBlocksList → buildVisibleList).

Design decisions (SURVEY.md §7):
- the hash table is three flat int arrays (pos/ptr/offset) probed with
  vectorized gathers and a statically-unrolled chain walk — no pointers;
- CUDA's atomic free-list pops become a cumsum over the per-entry allocation
  plan + a slice of the free stack;
- the "which pixel wins a contended bucket" race becomes a duplicate-index
  scatter (unspecified winner), reproducing the reference's benign
  last-writer-wins collision semantics including same-frame deferral;
- prefix-sum stream compaction of the visible list is `jnp.nonzero(size=K)`.

entry_ptr semantics (reference ITMHashEntry.ptr): ≥0 → block index in the
VBA; −1 → allocated but swapped out to host; ≤−2 → empty entry.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax.numpy as jnp

from infinitam_tpu.config import VoxelBlockHashParams
from infinitam_tpu.ops.hashing import hash_index, point_to_block

FREE_PTR = -2  # empty hash entry
SWAPPED_PTR = -1  # allocated, streamed out to the host tier

# Quantized PACKED voxel storage. Reference layout: ITMVoxel_s_rgb
# (ITMLibDefines.h:80-106 — sdf as short scaled by 32767, w_depth/w_color as
# uchar, clr as uchar3). Here the depth voxel packs into ONE int32 lane
# (sdf:int16 << 16 | w:uint8 << 8) and the color voxel into a second
# (r<<24|g<<16|b<<8|w_color): the hot phases are gather/scatter-bound, and
# one plane halves their transaction count.
SDF_SCALE = 32767.0
VOX_INIT = jnp.int32(32767 << 16)  # empty space: sdf = 1.0, w = 0


def sdf_to_q(f: jnp.ndarray) -> jnp.ndarray:
    """float sdf in [-1,1] → int16-valued int32 (reference SDF_floatToValue;
    rounded rather than C-truncated — ≤1 LSB difference, strictly less bias)."""
    return jnp.round(jnp.clip(f, -1.0, 1.0) * SDF_SCALE).astype(jnp.int32)


def sdf_from_q(q: jnp.ndarray) -> jnp.ndarray:
    """int16-valued int → float sdf (reference SDF_valueToFloat)."""
    return q.astype(jnp.float32) * (1.0 / SDF_SCALE)


def clr_to_q(c: jnp.ndarray) -> jnp.ndarray:
    """float rgb 0..1 → uint8-valued int32 (reference TO_UCHAR3(c*255))."""
    return jnp.round(jnp.clip(c, 0.0, 1.0) * 255.0).astype(jnp.int32)


def clr_from_q(q: jnp.ndarray) -> jnp.ndarray:
    return q.astype(jnp.float32) * (1.0 / 255.0)


# --- packed-lane accessors -------------------------------------------------
def pack_vox(sdf_q: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """(sdf int16, w uint8) → packed int32 lane."""
    sdf_q = jnp.asarray(sdf_q, dtype=jnp.int32)
    w = jnp.asarray(w, dtype=jnp.int32)
    return ((sdf_q & 0xFFFF) << 16) | ((w & 0xFF) << 8)


def vox_sdf_q(vox: jnp.ndarray) -> jnp.ndarray:
    """packed → sdf int16 (sign-extended int32)."""
    return vox >> 16


def vox_sdf(vox: jnp.ndarray) -> jnp.ndarray:
    """packed → float sdf."""
    return sdf_from_q(vox >> 16)


def vox_w(vox: jnp.ndarray) -> jnp.ndarray:
    """packed → fusion weight int32."""
    return (vox >> 8) & 0xFF


def pack_rgb(clr_q: jnp.ndarray, wc: jnp.ndarray) -> jnp.ndarray:
    """(clr uint8 [...,3], w_color uint8) → packed int32 lane."""
    c = jnp.asarray(clr_q, dtype=jnp.int32) & 0xFF
    wc = jnp.asarray(wc, dtype=jnp.int32)
    return (c[..., 0] << 24) | (c[..., 1] << 16) | (c[..., 2] << 8) | (wc & 0xFF)


def rgb_clr_q(vox_rgb: jnp.ndarray) -> jnp.ndarray:
    """packed → clr uint8-valued int32 [..., 3]."""
    return jnp.stack(
        [(vox_rgb >> 24) & 0xFF, (vox_rgb >> 16) & 0xFF, (vox_rgb >> 8) & 0xFF],
        axis=-1,
    )


def rgb_wc(vox_rgb: jnp.ndarray) -> jnp.ndarray:
    return vox_rgb & 0xFF

# visible_type codes (reference ITMRenderState_VH semantics)
VT_NOT_VISIBLE = 0
VT_VISIBLE = 1
VT_VISIBLE_SWAPPED = 2
VT_VISIBLE_PREVIOUS = 3

# static bound on hash-chain walks; the default table's load factor is ~6%
# so chains beyond a few links are vanishingly rare
MAX_PROBE = 4


class HashVolume(NamedTuple):
    entry_pos: jnp.ndarray  # [E, 3] int32 block coords
    entry_ptr: jnp.ndarray  # [E] int32 (see semantics above)
    entry_offset: jnp.ndarray  # [E] int32: 0 = chain end, k>0 → excess idx k−1
    vox: jnp.ndarray  # [B, S³] int32 packed sdf<<16|w<<8 (lin idx x+y·S+z·S²)
    alloc_list: jnp.ndarray  # [B] int32 free block stack
    last_free_block: jnp.ndarray  # scalar int32: index of stack top
    excess_list: jnp.ndarray  # [X] int32 free excess-entry stack
    last_free_excess: jnp.ndarray  # scalar int32
    vox_rgb: Optional[jnp.ndarray] = None  # [B, S³] int32 packed r,g,b,w_color
    # --- incrementally-maintained accelerator caches (a per-frame rebuild
    # would scan all E entries). Both are exact
    # mirrors of the hash state, updated at every mutation site
    # (insert_blocks, swap_out_blocks, reallocate_swapped_out):
    # dense cell→entry grid over the working window, [G³] flat int32 packed
    # (entry_idx << 1) | swapped; −1 = no entry (see build_entry_grid)
    entry_grid: Optional[jnp.ndarray] = None
    # dense cell→VBA-pointer grid, [G³] flat int32; −1 = not resident
    block_grid: Optional[jnp.ndarray] = None


class RenderStateVH(NamedTuple):
    """Visible-entry bookkeeping (reference: ITMRenderState_VH:18).

    The compact `visible_ids` list is canonical. `visible_type` keeps the
    reference's per-entry code plane for the swapping protocol and the legacy
    (oracle) alloc path; the fast alloc path maintains it only when swapping
    is on. `cell_claim`/`entry_epoch`/`epoch` power the compact allocator:
    `cell_claim[c]` holds the
    index of the candidate row that last claimed grid cell c — cells touched
    THIS frame always hold a current claim (the scatter rewrites them), so a
    claim is validated by checking the claimed row back (`c2_cell[j] == c`),
    never by clearing the plane. `entry_epoch` tags hash entries touched via
    the out-of-grid path with the frame epoch."""

    visible_type: jnp.ndarray  # [E] int32 (VT_* codes)
    visible_ids: jnp.ndarray  # [V] int32, −1 padding
    n_visible: jnp.ndarray  # scalar int32
    cell_claim: Optional[jnp.ndarray] = None  # [G³] int32 — winning candidate row per cell
    entry_epoch: Optional[jnp.ndarray] = None  # [E] int32 — frame tag (OOG dedupe)
    epoch: Optional[jnp.ndarray] = None  # scalar int32 — current frame tag


def sentinel_row(params: VoxelBlockHashParams) -> int:
    """VBA row reserved as a never-allocated no-op target: the Pallas
    integrate kernel routes invalid/swapped grid steps here so their aliased
    write-back can't clobber a live block."""
    return params.n_blocks - 1


def create_hash(
    params: VoxelBlockHashParams,
    with_color: bool = False,
    grid_params=None,
) -> HashVolume:
    """Allocate + reset (reference: ITMVoxelBlockHash ctor + ResetScene —
    free lists full, all entries empty, sdf=1, w=0). The LAST VBA row is a
    reserved sentinel (see sentinel_row) — the free stack tops out at B−2.

    `grid_params` enables the incrementally-maintained accelerator caches
    (entry/block grids)."""
    E = params.n_entries
    B = params.n_blocks
    X = params.n_excess
    S3 = params.block_volume
    eg = bg = None
    if grid_params is not None:
        gx, gy, gz = grid_params.dims
        G3 = gx * gy * gz
        eg = jnp.full((G3,), -1, dtype=jnp.int32)
        bg = jnp.full((G3,), -1, dtype=jnp.int32)
    vol = HashVolume(
        entry_pos=jnp.zeros((E, 3), dtype=jnp.int32),
        entry_ptr=jnp.full((E,), FREE_PTR, dtype=jnp.int32),
        entry_offset=jnp.zeros((E,), dtype=jnp.int32),
        vox=jnp.full((B, S3), VOX_INIT, dtype=jnp.int32),
        alloc_list=jnp.arange(B, dtype=jnp.int32),
        last_free_block=jnp.array(B - 2, dtype=jnp.int32),
        excess_list=jnp.arange(X, dtype=jnp.int32),
        last_free_excess=jnp.array(X - 1, dtype=jnp.int32),
        vox_rgb=jnp.zeros((B, S3), dtype=jnp.int32) if with_color else None,
        entry_grid=eg,
        block_grid=bg,
    )
    return vol


def grid_cell(block_pos: jnp.ndarray, grid_params) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(flat cell index, in-bounds mask) of block coords in the working grid."""
    gx, gy, gz = grid_params.dims
    g = block_pos - jnp.array(grid_params.origin, dtype=jnp.int32)
    inb = (
        (g[..., 0] >= 0) & (g[..., 0] < gx)
        & (g[..., 1] >= 0) & (g[..., 1] < gy)
        & (g[..., 2] >= 0) & (g[..., 2] < gz)
    )
    return (g[..., 0] * gy + g[..., 1]) * gz + g[..., 2], inb


def create_render_state(params: VoxelBlockHashParams, grid_params=None) -> RenderStateVH:
    ce = ee = ep = None
    if grid_params is not None:
        gx, gy, gz = grid_params.dims
        ce = jnp.zeros((gx * gy * gz,), dtype=jnp.int32)
        ee = jnp.zeros((params.n_entries,), dtype=jnp.int32)
        ep = jnp.array(0, dtype=jnp.int32)
    return RenderStateVH(
        visible_type=jnp.zeros((params.n_entries,), dtype=jnp.int32),
        visible_ids=jnp.full((params.max_visible_blocks,), -1, dtype=jnp.int32),
        n_visible=jnp.array(0, dtype=jnp.int32),
        cell_claim=ce,
        entry_epoch=ee,
        epoch=ep,
    )


class ProbeResult(NamedTuple):
    found: jnp.ndarray  # bool: matching entry with ptr ≥ min_ptr
    entry_idx: jnp.ndarray  # int32 entry index when found (else arbitrary)
    entry_ptr: jnp.ndarray  # ptr at the found entry (garbage when not found)
    tail_idx: jnp.ndarray  # last entry index visited in the chain
    ordered_empty: jnp.ndarray  # bool: the ordered bucket itself is empty


def pack_entries(vol: HashVolume) -> jnp.ndarray:
    """[E, 5] int32 (pos.xyz, ptr, offset) — one row-gather per chain link
    instead of three separate table gathers."""
    return jnp.concatenate(
        [vol.entry_pos, vol.entry_ptr[:, None], vol.entry_offset[:, None]], axis=1
    )


def probe(
    vol: HashVolume,
    block_pos: jnp.ndarray,  # [..., 3] int32
    params: VoxelBlockHashParams,
    include_swapped: bool = True,
    packed: Optional[jnp.ndarray] = None,  # pack_entries(vol), reused across calls
) -> ProbeResult:
    """Vectorized hash-chain walk (reference: findVoxel hash overload,
    ITMRepresentationAccess.h:22-54, statically unrolled to MAX_PROBE links).
    """
    min_ptr = SWAPPED_PTR if include_swapped else 0
    if packed is None:
        packed = pack_entries(vol)
    idx0 = hash_index(block_pos, params.hash_mask)

    cur = idx0
    found = jnp.zeros(block_pos.shape[:-1], dtype=bool)
    found_idx = idx0
    found_ptr = jnp.full(block_pos.shape[:-1], FREE_PTR, dtype=jnp.int32)
    tail = idx0
    ordered_empty = None

    for k in range(MAX_PROBE):
        row = packed[cur]  # [..., 5]
        pos = row[..., :3]
        ptr = row[..., 3]
        off = row[..., 4]
        if k == 0:
            ordered_empty = ptr < SWAPPED_PTR
        match = jnp.all(pos == block_pos, axis=-1) & (ptr >= min_ptr) & ~found
        found_idx = jnp.where(match, cur, found_idx)
        found_ptr = jnp.where(match, ptr, found_ptr)
        found = found | match
        has_next = (off >= 1) & ~found
        nxt = params.n_buckets + off - 1
        tail = jnp.where(has_next, nxt, tail)
        cur = jnp.where(has_next, nxt, cur)

    return ProbeResult(
        found=found,
        entry_idx=found_idx,
        entry_ptr=found_ptr,
        tail_idx=tail,
        ordered_empty=ordered_empty,
    )


def make_hash_reader(vol: HashVolume, params: VoxelBlockHashParams):
    """`(int voxel pts) -> (sdf, found)` closure for ops/voxel_access.py
    combinators (reference: readVoxel hash overload — empty voxel sdf = 1)."""
    S = params.block_size

    def read(pts_int: jnp.ndarray):
        block, linear = point_to_block(pts_int, S)
        pr = probe(vol, block, params, include_swapped=False)
        blk = jnp.where(pr.found, pr.entry_ptr, 0)
        sdf = vox_sdf(vol.vox[blk, linear])
        return jnp.where(pr.found, sdf, 1.0), pr.found

    return read


def make_hash_weight_reader(vol: HashVolume, params: VoxelBlockHashParams):
    """`(int voxel pts) -> (w_depth, found)` — fusion-confidence lookups for
    the reference's WeightToUchar4 display path."""
    S = params.block_size

    def read(pts_int: jnp.ndarray):
        block, linear = point_to_block(pts_int, S)
        pr = probe(vol, block, params, include_swapped=False)
        blk = jnp.where(pr.found, pr.entry_ptr, 0)
        w = vox_w(vol.vox[blk, linear]).astype(jnp.float32)
        return jnp.where(pr.found, w, 0.0), pr.found

    return read


def make_grid_weight_reader(vol: HashVolume, grid: jnp.ndarray, grid_params, params: VoxelBlockHashParams):
    """Grid-accelerated variant of make_hash_weight_reader."""
    S = params.block_size
    gx, gy, gz = grid_params.dims
    origin = jnp.array(grid_params.origin, dtype=jnp.int32)

    def read(pts_int: jnp.ndarray):
        block, linear = point_to_block(pts_int, S)
        g = block - origin
        inb = (
            (g[..., 0] >= 0) & (g[..., 0] < gx)
            & (g[..., 1] >= 0) & (g[..., 1] < gy)
            & (g[..., 2] >= 0) & (g[..., 2] < gz)
        )
        gc = jnp.clip(g, 0, jnp.array([gx - 1, gy - 1, gz - 1], dtype=jnp.int32))
        ptr = grid[gc[..., 0], gc[..., 1], gc[..., 2]]
        found = inb & (ptr >= 0)
        w = vox_w(vol.vox[jnp.where(found, ptr, 0), linear]).astype(jnp.float32)
        return jnp.where(found, w, 0.0), found

    return read


def make_hash_color_reader(vol: HashVolume, params: VoxelBlockHashParams):
    S = params.block_size

    def read(pts_int: jnp.ndarray):
        if vol.vox_rgb is None:
            return jnp.zeros(pts_int.shape[:-1] + (3,), dtype=jnp.float32)
        block, linear = point_to_block(pts_int, S)
        pr = probe(vol, block, params, include_swapped=False)
        blk = jnp.where(pr.found, pr.entry_ptr, 0)
        c = clr_from_q(rgb_clr_q(vol.vox_rgb[blk, linear]))
        return jnp.where(pr.found[..., None], c, 0.0)

    return read


class AllocationPlan(NamedTuple):
    alloc_type: jnp.ndarray  # [E] int32: 0 none, 1 ordered, 2 excess
    block_coords: jnp.ndarray  # [E, 3] int32 requested block pos
    visible_type: jnp.ndarray  # [E] int32 updated visibility marks
    cand_need: jnp.ndarray  # [N] bool: candidate not found (allocation wanted)


def plan_allocations(
    vol: HashVolume,
    visible_type: jnp.ndarray,  # [E] int32 (entries from last frame pre-set to 3)
    cand_blocks: jnp.ndarray,  # [N, 3] int32 candidate block coords
    cand_valid: jnp.ndarray,  # [N] bool
    params: VoxelBlockHashParams,
    packed: Optional[jnp.ndarray] = None,
) -> AllocationPlan:
    """Mark entries to allocate + visibility of touched entries (reference:
    buildHashAllocAndVisibleTypePP scatter phase). Contended buckets keep ONE
    winner per frame (duplicate-index scatter), like the reference's benign
    last-writer-wins CUDA race; losers retry next frame."""
    E = params.n_entries
    pr = probe(vol, cand_blocks, params, include_swapped=True, packed=packed)

    # visibility marks for found entries: 2 if swapped out, 1 otherwise
    vis_val = jnp.where(pr.entry_ptr == SWAPPED_PTR, VT_VISIBLE_SWAPPED, VT_VISIBLE)
    vis_idx = jnp.where(cand_valid & pr.found, pr.entry_idx, E)  # E → dropped
    visible_type = visible_type.at[vis_idx].set(
        jnp.where(cand_valid & pr.found, vis_val, 0), mode="drop"
    )

    need = cand_valid & ~pr.found
    a_type = jnp.where(pr.ordered_empty, 1, 2)
    tidx = jnp.where(need, pr.tail_idx, E)

    alloc_type = jnp.zeros((E,), dtype=jnp.int32).at[tidx].set(
        jnp.where(need, a_type, 0), mode="drop"
    )
    block_coords = jnp.zeros((E, 3), dtype=jnp.int32).at[tidx].set(
        cand_blocks, mode="drop"
    )
    # new ordered entries are visible immediately (reference: planning sets
    # entriesVisibleType[hashIdx]=1 for !isExcess)
    vidx1 = jnp.where(need & (a_type == 1), pr.tail_idx, E)
    visible_type = visible_type.at[vidx1].set(VT_VISIBLE, mode="drop")
    return AllocationPlan(
        alloc_type=alloc_type,
        block_coords=block_coords,
        visible_type=visible_type,
        cand_need=need,
    )


def execute_allocations(
    vol: HashVolume, plan: AllocationPlan, params: VoxelBlockHashParams
) -> Tuple[HashVolume, jnp.ndarray]:
    """Pop free lists and write new entries (reference:
    allocateVoxelBlocksList_device). Returns (vol, visible_type) — excess
    children become visible here."""
    E = params.n_entries
    visible_type = plan.visible_type

    needs_block = plan.alloc_type > 0
    needs_excess = plan.alloc_type == 2

    block_rank = jnp.cumsum(needs_block.astype(jnp.int32)) - 1  # [E]
    excess_rank = jnp.cumsum(needs_excess.astype(jnp.int32)) - 1

    blk_list_idx = vol.last_free_block - block_rank
    exl_list_idx = vol.last_free_excess - excess_rank
    has_block = needs_block & (blk_list_idx >= 0)
    has_excess = needs_excess & (exl_list_idx >= 0)

    new_block = vol.alloc_list[jnp.clip(blk_list_idx, 0, vol.alloc_list.shape[0] - 1)]
    excess_slot = vol.excess_list[jnp.clip(exl_list_idx, 0, vol.excess_list.shape[0] - 1)]

    entry_pos = vol.entry_pos
    entry_ptr = vol.entry_ptr
    entry_offset = vol.entry_offset

    # --- type 1: write the ordered bucket itself -----------------------
    do1 = (plan.alloc_type == 1) & has_block
    idx1 = jnp.where(do1, jnp.arange(E), E)
    entry_pos = entry_pos.at[idx1].set(plan.block_coords, mode="drop")
    entry_ptr = entry_ptr.at[idx1].set(new_block, mode="drop")
    entry_offset = entry_offset.at[idx1].set(0, mode="drop")

    # --- type 2: write an excess child + link parent -------------------
    do2 = (plan.alloc_type == 2) & has_block & has_excess
    child = params.n_buckets + excess_slot
    cidx = jnp.where(do2, child, E)
    entry_pos = entry_pos.at[cidx].set(plan.block_coords, mode="drop")
    entry_ptr = entry_ptr.at[cidx].set(new_block, mode="drop")
    entry_offset = entry_offset.at[cidx].set(0, mode="drop")
    pidx = jnp.where(do2, jnp.arange(E), E)
    entry_offset = entry_offset.at[pidx].set(excess_slot + 1, mode="drop")
    visible_type = visible_type.at[cidx].set(VT_VISIBLE, mode="drop")

    n_blocks_taken = jnp.sum((do1 | do2).astype(jnp.int32))
    n_excess_taken = jnp.sum(do2.astype(jnp.int32))

    new_vol = vol._replace(
        entry_pos=entry_pos,
        entry_ptr=entry_ptr,
        entry_offset=entry_offset,
        last_free_block=vol.last_free_block - n_blocks_taken,
        last_free_excess=vol.last_free_excess - n_excess_taken,
    )
    return new_vol, visible_type


def build_entry_grid(vol: HashVolume, grid_params) -> jnp.ndarray:
    """Dense block→hash-entry index grid over the working volume, the
    candidate-space allocation accelerator (the reference probes the hash
    per pixel instead, buildHashAllocAndVisibleTypePP; one dense-grid tap
    replaces a chain walk of up to MAX_PROBE gathers).

    [G³] flat int32, packed `(entry_idx << 1) | swapped`; −1 = no allocated
    entry for that cell. Includes swapped-out entries (ptr == −1) so the
    allocator can mark them visible-swapped instead of re-allocating."""
    gx, gy, gz = grid_params.dims
    ox, oy, oz = grid_params.origin
    p = vol.entry_pos - jnp.array([ox, oy, oz], dtype=jnp.int32)
    inb = (
        (vol.entry_ptr >= SWAPPED_PTR)
        & (p[:, 0] >= 0) & (p[:, 0] < gx)
        & (p[:, 1] >= 0) & (p[:, 1] < gy)
        & (p[:, 2] >= 0) & (p[:, 2] < gz)
    )
    flat = jnp.where(inb, (p[:, 0] * gy + p[:, 1]) * gz + p[:, 2], gx * gy * gz)
    E = vol.entry_ptr.shape[0]
    code = (jnp.arange(E, dtype=jnp.int32) << 1) | (vol.entry_ptr == SWAPPED_PTR)
    grid = jnp.full((gx * gy * gz,), -1, dtype=jnp.int32)
    return grid.at[flat].set(jnp.where(inb, code, -1), mode="drop")


def insert_blocks(
    vol: HashVolume,
    visible_type: jnp.ndarray,  # [E] int32
    new_blocks: jnp.ndarray,  # [N, 3] int32 block coords, UNKNOWN to the hash
    valid: jnp.ndarray,  # [N] bool
    params: VoxelBlockHashParams,
    grid_params=None,
) -> Tuple[HashVolume, jnp.ndarray]:
    """Candidate-space hash insertion: probe → per-bucket winner election →
    free-list pops → entry writes, all O(N) (no [E]-sized cumsum — the
    round-1 allocator's cost). Reference semantics preserved
    (allocateVoxelBlocksList_device): contended buckets keep one winner per
    frame (losers retry next frame — the benign CUDA race), excess chaining
    via the offset links, new entries marked visible immediately.

    Returns (vol, visible_type, widx) — widx[N] is the hash-entry index each
    candidate was written to, or E for candidates that did not insert."""
    E = params.n_entries
    N = new_blocks.shape[0]
    pr = probe(vol, new_blocks, params, include_swapped=True)
    need = valid & ~pr.found
    a_type = jnp.where(pr.ordered_empty, 1, 2)  # 1 ordered, 2 excess append
    tidx = jnp.where(need, pr.tail_idx, E)

    # winner election on contended buckets/chain-tails: duplicate-index
    # scatter (unspecified winner) + gather-back check
    claim = jnp.full((E + 1,), -1, jnp.int32).at[tidx].set(
        jnp.arange(N, dtype=jnp.int32), mode="drop"
    )
    win = need & (claim[jnp.clip(tidx, 0, E)] == jnp.arange(N))

    # rank ONLY candidates that actually take a resource, so the stack
    # pointers stay exactly consistent when a free list runs dry (failures
    # are then always the tail ranks — no stack slot is skipped-but-counted)
    needs_excess = win & (a_type == 2)
    excess_rank = jnp.cumsum(needs_excess.astype(jnp.int32)) - 1
    exl_list_idx = vol.last_free_excess - excess_rank
    has_excess = needs_excess & (exl_list_idx >= 0)
    take = win & ((a_type == 1) | has_excess)
    block_rank = jnp.cumsum(take.astype(jnp.int32)) - 1
    blk_list_idx = vol.last_free_block - block_rank
    has_block = take & (blk_list_idx >= 0)

    new_block = vol.alloc_list[jnp.clip(blk_list_idx, 0, vol.alloc_list.shape[0] - 1)]
    excess_slot = vol.excess_list[jnp.clip(exl_list_idx, 0, vol.excess_list.shape[0] - 1)]

    do1 = has_block & (a_type == 1)
    do2 = has_block & (a_type == 2)
    # entry written: the bucket itself (type 1) or a fresh excess child (type 2)
    child = params.n_buckets + excess_slot
    widx = jnp.where(do1, tidx, jnp.where(do2, child, E))

    entry_pos = vol.entry_pos.at[widx].set(new_blocks, mode="drop")
    entry_ptr = vol.entry_ptr.at[widx].set(new_block, mode="drop")
    entry_offset = vol.entry_offset.at[widx].set(0, mode="drop")
    # link parent → excess child
    pidx = jnp.where(do2, tidx, E)
    entry_offset = entry_offset.at[pidx].set(excess_slot + 1, mode="drop")

    visible_type = visible_type.at[widx].set(VT_VISIBLE, mode="drop")

    n_blocks_taken = jnp.sum((do1 | do2).astype(jnp.int32))
    n_excess_taken = jnp.sum(do2.astype(jnp.int32))
    new_vol = vol._replace(
        entry_pos=entry_pos,
        entry_ptr=entry_ptr,
        entry_offset=entry_offset,
        last_free_block=vol.last_free_block - n_blocks_taken,
        last_free_excess=vol.last_free_excess - n_excess_taken,
    )

    # maintain the accelerator caches (exact mirrors of the writes above)
    if grid_params is not None and vol.entry_grid is not None:
        done = do1 | do2
        cell, inb = grid_cell(new_blocks, grid_params)
        G3 = vol.entry_grid.shape[0]
        cidx = jnp.where(done & inb, cell, G3)
        new_vol = new_vol._replace(
            entry_grid=vol.entry_grid.at[cidx].set(widx << 1, mode="drop"),
            block_grid=vol.block_grid.at[cidx].set(new_block, mode="drop"),
        )
    return new_vol, visible_type, widx


def refresh_caches(vol: HashVolume, grid_params) -> HashVolume:
    """Rebuild all accelerator caches from the canonical hash state (used at
    creation-from-snapshot / migration time; per-frame they are maintained
    incrementally). Also the test oracle for the incremental updates."""
    eg = build_entry_grid(vol, grid_params)
    bg = build_block_grid(vol, grid_params, None).reshape(-1)
    return vol._replace(entry_grid=eg, block_grid=bg)


def get_block_grid(vol: HashVolume, grid_params, params: VoxelBlockHashParams) -> jnp.ndarray:
    """[Gx,Gy,Gz] cell→ptr grid: the incrementally-maintained cache when
    present, else a per-call rebuild."""
    if vol.block_grid is not None:
        gx, gy, gz = grid_params.dims
        return vol.block_grid.reshape(gx, gy, gz)
    return build_block_grid(vol, grid_params, params)


def build_block_grid(vol: HashVolume, grid_params, params) -> jnp.ndarray:
    """Dense block→VBA-pointer index grid over the working volume (raycast
    accelerator; see config.BlockGridParams). [Gx, Gy, Gz] int32 with
    −1 = unallocated; built by one scatter over the hash entries."""
    gx, gy, gz = grid_params.dims
    ox, oy, oz = grid_params.origin
    p = vol.entry_pos - jnp.array([ox, oy, oz], dtype=jnp.int32)
    inb = (
        (vol.entry_ptr >= 0)
        & (p[:, 0] >= 0) & (p[:, 0] < gx)
        & (p[:, 1] >= 0) & (p[:, 1] < gy)
        & (p[:, 2] >= 0) & (p[:, 2] < gz)
    )
    flat = jnp.where(inb, p[:, 0] * gy * gz + p[:, 1] * gz + p[:, 2], gx * gy * gz)
    grid = jnp.full((gx * gy * gz,), -1, dtype=jnp.int32)
    grid = grid.at[flat].set(jnp.where(inb, vol.entry_ptr, -1), mode="drop")
    return grid.reshape(gx, gy, gz)


def make_grid_reader(vol: HashVolume, grid: jnp.ndarray, grid_params, params: VoxelBlockHashParams):
    """`(int voxel pts) -> (sdf, found)` via the dense block grid: one int
    gather + one voxel gather per tap (vs a 4-link hash-chain walk)."""
    S = params.block_size
    gx, gy, gz = grid_params.dims
    origin = jnp.array(grid_params.origin, dtype=jnp.int32)

    def read(pts_int: jnp.ndarray):
        block, linear = point_to_block(pts_int, S)
        g = block - origin
        inb = (
            (g[..., 0] >= 0) & (g[..., 0] < gx)
            & (g[..., 1] >= 0) & (g[..., 1] < gy)
            & (g[..., 2] >= 0) & (g[..., 2] < gz)
        )
        gc = jnp.clip(g, 0, jnp.array([gx - 1, gy - 1, gz - 1], dtype=jnp.int32))
        ptr = grid[gc[..., 0], gc[..., 1], gc[..., 2]]
        found = inb & (ptr >= 0)
        sdf = vox_sdf(vol.vox[jnp.where(found, ptr, 0), linear])
        return jnp.where(found, sdf, 1.0), found

    return read


def check_block_visibility(
    block_pos: jnp.ndarray,  # [..., 3]
    M_d: jnp.ndarray,
    proj: jnp.ndarray,
    img_size: Tuple[int, int],
    voxel_size: float,
    block_size: int,
    enlarged: bool = False,
) -> jnp.ndarray:
    """Project the 8 block corners; visible if any lands in the image
    (reference: checkBlockVisibility / checkPointVisibility; `enlarged` pads
    the bounds by 1/8 image for the swapping path).

    Layout: the [..., 3] input is split into component planes once; the
    corner loop runs on flat vectors (corner c projects as R·b·f + t + R·c·f
    — one base transform plus a per-corner constant), so nothing keeps a
    3-wide minor dim in the lane axis."""
    H, W = img_size
    fx, fy, cx, cy = proj[0], proj[1], proj[2], proj[3]
    factor = block_size * voxel_size
    bx = block_pos[..., 0].astype(jnp.float32) * factor
    by = block_pos[..., 1].astype(jnp.float32) * factor
    bz = block_pos[..., 2].astype(jnp.float32) * factor
    R = M_d[:3, :3]
    t = M_d[:3, 3]
    px0 = R[0, 0] * bx + R[0, 1] * by + R[0, 2] * bz + t[0]
    py0 = R[1, 0] * bx + R[1, 1] * by + R[1, 2] * bz + t[1]
    pz0 = R[2, 0] * bx + R[2, 1] * by + R[2, 2] * bz + t[2]
    vis = jnp.zeros(px0.shape, dtype=bool)
    if enlarged:
        x_lo, x_hi = -W / 8.0, W + W / 8.0
        y_lo, y_hi = -H / 8.0, H + H / 8.0
    else:
        x_lo, x_hi, y_lo, y_hi = 0.0, float(W), 0.0, float(H)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                co = (R[:, 0] * dx + R[:, 1] * dy + R[:, 2] * dz) * factor
                z = pz0 + co[2]
                ok = z >= 1e-10
                zs = jnp.where(ok, z, 1.0)
                u = fx * (px0 + co[0]) / zs + cx
                v = fy * (py0 + co[1]) / zs + cy
                vis |= ok & (u >= x_lo) & (u < x_hi) & (v >= y_lo) & (v < y_hi)
    return vis


def check_block_visibility_planes(
    bx_i: jnp.ndarray,  # [...] int32 block x coords (component planes)
    by_i: jnp.ndarray,
    bz_i: jnp.ndarray,
    M_d: jnp.ndarray,
    proj: jnp.ndarray,
    img_size: Tuple[int, int],
    voxel_size: float,
    block_size: int,
    enlarged: bool = False,
) -> jnp.ndarray:
    """check_block_visibility on pre-split component planes — for callers
    whose positions come from flat [N] gathers."""
    H, W = img_size
    fx, fy, cx, cy = proj[0], proj[1], proj[2], proj[3]
    factor = block_size * voxel_size
    bx = bx_i.astype(jnp.float32) * factor
    by = by_i.astype(jnp.float32) * factor
    bz = bz_i.astype(jnp.float32) * factor
    R = M_d[:3, :3]
    t = M_d[:3, 3]
    px0 = R[0, 0] * bx + R[0, 1] * by + R[0, 2] * bz + t[0]
    py0 = R[1, 0] * bx + R[1, 1] * by + R[1, 2] * bz + t[1]
    pz0 = R[2, 0] * bx + R[2, 1] * by + R[2, 2] * bz + t[2]
    vis = jnp.zeros(px0.shape, dtype=bool)
    if enlarged:
        x_lo, x_hi = -W / 8.0, W + W / 8.0
        y_lo, y_hi = -H / 8.0, H + H / 8.0
    else:
        x_lo, x_hi, y_lo, y_hi = 0.0, float(W), 0.0, float(H)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                co = (R[:, 0] * dx + R[:, 1] * dy + R[:, 2] * dz) * factor
                z = pz0 + co[2]
                ok = z >= 1e-10
                zs = jnp.where(ok, z, 1.0)
                u = fx * (px0 + co[0]) / zs + cx
                v = fy * (py0 + co[1]) / zs + cy
                vis |= ok & (u >= x_lo) & (u < x_hi) & (v >= y_lo) & (v < y_hi)
    return vis


def build_visible_list(
    vol: HashVolume,
    visible_type: jnp.ndarray,
    M_d: jnp.ndarray,
    proj: jnp.ndarray,
    img_size: Tuple[int, int],
    voxel_size: float,
    params: VoxelBlockHashParams,
    use_enlarged: bool = False,
    prev_ids: Optional[jnp.ndarray] = None,
) -> RenderStateVH:
    """Re-check carried-over entries and compact the visible list
    (reference: buildVisibleList_device — type-3 entries get a projection
    re-check; prefix-sum compaction → `jnp.nonzero(size=·)`).

    With `prev_ids` (last frame's compact visible list) the projection
    re-check runs over those ≤V rows only — type-3 entries are exactly last
    frame's visibles, so this is lossless and ~E/V cheaper. This is the
    ORACLE path (full-plane semantics); the hot path builds the compact list
    directly in hash_pipeline.allocate_scene_from_depth."""
    E = params.n_entries
    if prev_ids is not None:
        pid_c = jnp.clip(prev_ids, 0, E - 1)
        is_prev = (prev_ids >= 0) & (visible_type[pid_c] == VT_VISIBLE_PREVIOUS)
        vis = check_block_visibility(
            vol.entry_pos[pid_c], M_d, proj, img_size, voxel_size,
            params.block_size, enlarged=use_enlarged,
        )
        demote = is_prev & ~vis
        visible_type = visible_type.at[jnp.where(demote, pid_c, E)].set(
            VT_NOT_VISIBLE, mode="drop"
        )
    else:
        recheck = visible_type == VT_VISIBLE_PREVIOUS
        vis = check_block_visibility(
            vol.entry_pos, M_d, proj, img_size, voxel_size, params.block_size,
            enlarged=use_enlarged,
        )
        visible_type = jnp.where(recheck & ~vis, VT_NOT_VISIBLE, visible_type)

    mask = visible_type > 0
    ids = jnp.nonzero(mask, size=params.max_visible_blocks, fill_value=-1)[0].astype(
        jnp.int32
    )
    n = jnp.sum(mask).astype(jnp.int32)
    return RenderStateVH(visible_type=visible_type, visible_ids=ids, n_visible=n)


def set_previous_visible(render_state: RenderStateVH) -> jnp.ndarray:
    """Start-of-frame: demote last frame's visible entries to type 3
    (reference: setToType3 kernel)."""
    ids = render_state.visible_ids
    E = render_state.visible_type.shape[0]
    vt = jnp.zeros_like(render_state.visible_type)
    idx = jnp.where(ids >= 0, ids, E)
    return vt.at[idx].set(VT_VISIBLE_PREVIOUS, mode="drop")
