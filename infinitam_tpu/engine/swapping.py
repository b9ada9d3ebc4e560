"""Host↔HBM voxel-block streaming (swapping) — scenes larger than device
memory.

Reference parity: ITMLib/Objects/ITMGlobalCache.h:18-129 (host block store +
3-state machine + bounded transfer buffers) and
ITMSwappingEngine_CUDA.cu:42-296:
  swap-in : state==1 entries → compacted needed-list (≤ transfer cap) → host
            gather → upload → weighted-average merge into the VBA → state=2
  swap-out: state==2 ∧ allocated ∧ invisible → move+clear blocks → return to
            free list (ptr→−1) → download → host scatter → state=0

Shape: the device steps are three jitted fixed-shape programs
(compaction via nonzero(size=cap), merge/evict as gathers+scatters); the host
tier is plain numpy arrays with `jax.device_get/put` at the slab boundary —
the analogue of the reference's pinned-buffer cudaMemcpy path.

swap_states codes (reference ITMHashSwapState): 0 = most recent data on
host / nowhere, 1 = on host, needs combining with device, 2 = device newest.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from infinitam_tpu.config import Settings
from infinitam_tpu.engine.hash_volume import HashVolume, RenderStateVH


@dataclasses.dataclass
class GlobalCache:
    """Host-side store of all addressable blocks (reference: ITMGlobalCache —
    which stores WHOLE TVoxels, i.e. color planes too when the voxel type has
    them, ITMGlobalCache.h:18-40). Indexed by hash-entry id like the
    reference."""

    stored_sdf: np.ndarray  # [E, S³] int16 (×32767, like the live volume)
    stored_w: np.ndarray  # [E, S³] uint8
    has_stored: np.ndarray  # [E] bool
    stored_clr: Optional[np.ndarray] = None  # [E, S³, 3] uint8 (use_color)
    stored_wc: Optional[np.ndarray] = None  # [E, S³] uint8

    @classmethod
    def create(cls, settings: Settings) -> "GlobalCache":
        E = settings.hashing.n_entries
        S3 = settings.hashing.block_volume
        return cls(
            stored_sdf=np.full((E, S3), 32767, dtype=np.int16),
            stored_w=np.zeros((E, S3), dtype=np.uint8),
            has_stored=np.zeros((E,), dtype=bool),
            stored_clr=np.zeros((E, S3, 3), dtype=np.uint8) if settings.use_color else None,
            stored_wc=np.zeros((E, S3), dtype=np.uint8) if settings.use_color else None,
        )

    def save(self, path: str) -> None:
        """reference: ITMGlobalCache::SaveToFile."""
        extra = {}
        if self.stored_clr is not None:
            extra = {"clr": self.stored_clr, "wc": self.stored_wc}
        np.savez_compressed(
            path, sdf=self.stored_sdf, w=self.stored_w, has=self.has_stored, **extra
        )

    @classmethod
    def load(cls, path: str) -> "GlobalCache":
        z = np.load(path)
        return cls(
            stored_sdf=z["sdf"], stored_w=z["w"], has_stored=z["has"],
            stored_clr=z["clr"] if "clr" in z else None,
            stored_wc=z["wc"] if "wc" in z else None,
        )


def create_swap_states(settings: Settings) -> jnp.ndarray:
    return jnp.zeros((settings.hashing.n_entries,), dtype=jnp.int32)


@partial(jax.jit, static_argnames=("cap",))
def build_swap_in_list(swap_states: jnp.ndarray, cap: int):
    """reference: buildListToSwapIn_device — state==1, compacted, capped."""
    mask = swap_states == 1
    ids = jnp.nonzero(mask, size=cap, fill_value=-1)[0].astype(jnp.int32)
    return ids, jnp.minimum(jnp.sum(mask), cap).astype(jnp.int32)


# swap-state 3 (r5 extension to the reference's {0,1,2}): "merge in flight" —
# the entry is on a pipelined needed-list whose host gather has not landed
# yet. Excluded from re-listing and eviction; merge_swapped_in resolves it
# to 2. See SwapExchange.
SWAP_IN_FLIGHT = 3


@partial(jax.jit, static_argnames=("cap",))
def build_swap_in_list_mark(swap_states: jnp.ndarray, cap: int):
    """build_swap_in_list + flip the LISTED entries to the in-flight state,
    so the next frame's list (built before this list's merge lands) cannot
    re-list them — a re-list would double-combine the stored content."""
    mask = swap_states == 1
    ids = jnp.nonzero(mask, size=cap, fill_value=-1)[0].astype(jnp.int32)
    n = jnp.minimum(jnp.sum(mask), cap).astype(jnp.int32)
    E = swap_states.shape[0]
    swap_states = swap_states.at[
        jnp.where(ids >= 0, ids, E)
    ].set(SWAP_IN_FLIGHT, mode="drop")
    return ids, n, swap_states


def build_swap_in_list_visible(
    swap_states: jnp.ndarray, visible_ids: jnp.ndarray, cap: int
):
    """Needed-list build over the COMPACT visible list instead of a full
    [E] scan (state-1 entries are marked from visibility, so the visible
    list contains every freshly marked one; a state-1 entry that left the
    frustum before being listed re-lists when next visible — bounded
    deferral, matching the reference's cap deferral). Listed entries flip
    to the in-flight state like build_swap_in_list_mark."""
    from infinitam_tpu.ops.hashing import compact_by_mask

    E = swap_states.shape[0]
    idc = jnp.clip(visible_ids, 0, E - 1)
    need = (visible_ids >= 0) & (swap_states[idc] == 1)
    ids, n = compact_by_mask(need, idc, cap, fill=jnp.int32(-1))
    n = jnp.minimum(n, cap)
    swap_states = swap_states.at[
        jnp.where(ids >= 0, ids, E)
    ].set(SWAP_IN_FLIGHT, mode="drop")
    return ids, n, swap_states


def mark_visible_for_swap_compact(
    swap_states: jnp.ndarray, visible_ids: jnp.ndarray
) -> jnp.ndarray:
    """mark_visible_for_swap over the compact visible list (which by
    construction holds exactly the entries with visible_type>0): gather +
    scatter over ≤V rows instead of two full [E] plane passes."""
    E = swap_states.shape[0]
    idc = jnp.clip(visible_ids, 0, E - 1)
    st = swap_states[idc]
    new_st = jnp.where((st != 2) & (st != SWAP_IN_FLIGHT), 1, st)
    return swap_states.at[
        jnp.where(visible_ids >= 0, idc, E)
    ].set(new_st, mode="drop")


def _merge_core(
    vol: HashVolume,
    swap_states: jnp.ndarray,
    needed_ids: jnp.ndarray,  # [cap] entry ids, −1 padded
    src_sdf: jnp.ndarray,  # [cap, S³] float sdf (w==0 rows ignored)
    src_w: jnp.ndarray,  # [cap, S³] int32 (0 = no stored data)
    valid: jnp.ndarray,  # [cap] bool — rows allowed to merge
    settings: Settings,
    src_clr: Optional[jnp.ndarray] = None,  # [cap, S³, 3] float 0..1
    src_wc: Optional[jnp.ndarray] = None,  # [cap, S³] int32
) -> Tuple[HashVolume, jnp.ndarray]:
    hp = settings.hashing
    E = hp.n_entries
    B = vol.vox.shape[0]
    max_w = settings.scene.max_w

    ids_c = jnp.clip(needed_ids, 0, E - 1)
    ptr = vol.entry_ptr[ids_c]
    valid = valid & (needed_ids >= 0) & (ptr >= 0)
    ptr_c = jnp.where(valid, ptr, 0)

    from infinitam_tpu.engine.hash_volume import (
        clr_from_q,
        clr_to_q,
        pack_rgb,
        pack_vox,
        rgb_clr_q,
        rgb_wc,
        sdf_to_q,
        vox_sdf,
        vox_w,
    )

    dst_vox = vol.vox[ptr_c]
    dst_sdf = vox_sdf(dst_vox)
    dst_w = vox_w(dst_vox)

    # combineVoxelDepthInformation: if oldW (host) == 0 keep device voxel;
    # newF = (oldW·oldF + newW·newF)/(oldW+newW); newW capped at maxW.
    merged_w_raw = dst_w + src_w
    merged_sdf = (src_w * src_sdf + dst_w * dst_sdf) / jnp.maximum(merged_w_raw, 1)
    merged_w = jnp.minimum(merged_w_raw, max_w)
    use = (src_w > 0) & valid[:, None]
    out_sdf = jnp.where(use, merged_sdf, dst_sdf)
    out_w = jnp.where(use, merged_w, dst_w)

    scatter_idx = jnp.where(valid, ptr_c, B)
    vox = vol.vox.at[scatter_idx].set(
        pack_vox(sdf_to_q(out_sdf), out_w), mode="drop"
    )
    vox_rgb = vol.vox_rgb
    if vol.vox_rgb is not None and src_clr is not None:
        # combineVoxelColorInformation: same running average on (clr, w_color)
        dst_rgb = vol.vox_rgb[ptr_c]
        dst_clr = clr_from_q(rgb_clr_q(dst_rgb))
        dst_wc = rgb_wc(dst_rgb)
        src_wc = src_wc.astype(jnp.int32)
        merged_wc_raw = dst_wc + src_wc
        merged_clr = (
            src_wc[..., None] * src_clr + dst_wc[..., None] * dst_clr
        ) / jnp.maximum(merged_wc_raw, 1)[..., None]
        merged_wc = jnp.minimum(merged_wc_raw, max_w)
        use_c = (src_wc > 0) & valid[:, None]
        out_clr = jnp.where(use_c[..., None], merged_clr, dst_clr)
        out_wc = jnp.where(use_c, merged_wc, dst_wc)
        vox_rgb = vol.vox_rgb.at[scatter_idx].set(
            pack_rgb(clr_to_q(out_clr), out_wc), mode="drop"
        )

    sidx = jnp.where(needed_ids >= 0, ids_c, E)
    swap_states = swap_states.at[sidx].set(2, mode="drop")
    return vol._replace(vox=vox, vox_rgb=vox_rgb), swap_states


@partial(jax.jit, static_argnames=("settings",))
def merge_swapped_in(
    vol: HashVolume,
    swap_states: jnp.ndarray,
    needed_ids: jnp.ndarray,  # [cap] entry ids, −1 padded
    buf_sdf: jnp.ndarray,  # [cap, S³] int16 host-gathered blocks
    buf_w: jnp.ndarray,  # [cap, S³] uint8
    has_data: jnp.ndarray,  # [cap] bool
    settings: Settings,
    buf_clr: Optional[jnp.ndarray] = None,  # [cap, S³, 3]
    buf_wc: Optional[jnp.ndarray] = None,  # [cap, S³]
) -> Tuple[HashVolume, jnp.ndarray]:
    """reference: integrateOldIntoActiveData_device + combineVoxel*
    (DeviceAgnostic/ITMSwappingEngine.h:7-63) — fold the streamed-in running
    averages into the live blocks (depth AND color when the voxel has color);
    state→2 for every needed entry (even without stored data, matching the
    reference)."""
    from infinitam_tpu.engine.hash_volume import clr_from_q, sdf_from_q

    src_clr = None
    src_wc = None
    if vol.vox_rgb is not None and buf_clr is not None:
        src_clr = clr_from_q(buf_clr)
        src_wc = buf_wc.astype(jnp.int32)
    return _merge_core(
        vol, swap_states, needed_ids,
        sdf_from_q(buf_sdf), buf_w.astype(jnp.int32), has_data, settings,
        src_clr=src_clr, src_wc=src_wc,
    )


@partial(jax.jit, static_argnames=("settings", "with_color"))
def merge_data_slab(
    vol: HashVolume,
    swap_states: jnp.ndarray,
    slab: jnp.ndarray,  # [D(+D)+1, S³] int32 — see SwapExchange
    settings: Settings,
    with_color: bool = False,
) -> Tuple[HashVolume, jnp.ndarray]:
    """Single-operand merge for the pipelined exchange: the host packs the
    needed blocks THAT HAVE STORED DATA (usually none — only previously
    evicted, re-visible blocks) into one int32 slab: D packed voxel rows in
    the live pack_vox lane format (+D pack_rgb rows when color), last row =
    the data rows' entry ids in lanes 0..D−1. One H2D transfer sized to the
    actual data instead of the full transfer buffer."""
    from infinitam_tpu.engine.hash_volume import (
        clr_from_q,
        rgb_clr_q,
        rgb_wc,
        sdf_from_q,
        vox_sdf_q,
        vox_w,
    )

    rows = slab.shape[0]
    D = (rows - 1) // (2 if with_color else 1)
    ids = slab[-1, :D]
    packed = slab[:D]
    src_sdf = sdf_from_q(vox_sdf_q(packed))
    src_w = vox_w(packed)
    src_clr = None
    src_wc = None
    if with_color and vol.vox_rgb is not None:
        prgb = slab[D:2 * D]
        src_clr = clr_from_q(rgb_clr_q(prgb))
        src_wc = rgb_wc(prgb)
    return _merge_core(
        vol, swap_states, ids, src_sdf, src_w,
        jnp.ones(ids.shape, jnp.bool_), settings,
        src_clr=src_clr, src_wc=src_wc,
    )


@partial(jax.jit, static_argnames=("settings", "cap"))
def evict_blocks(
    vol: HashVolume,
    swap_states: jnp.ndarray,
    visible_type: jnp.ndarray,
    settings: Settings,
    cap: int | None = None,
):
    """reference: buildListToSwapOut + moveActiveDataToTransferBuffer +
    cleanMemory — select state==2 ∧ allocated ∧ invisible entries (≤ cap),
    copy their blocks out, reset them to empty, return blocks to the free
    list, ptr→−1 (swapped out), state→0.

    `cap` overrides the transfer-buffer size (default n_transfer_blocks;
    the pipelined exchange uses the fixed quantum so every frame's buffers
    share one compiled program). Entries beyond the cap stay state 2 and
    evict on a later frame.

    Returns (vol, swap_states, evicted_ids, buf_sdf, buf_w, buf_clr, buf_wc, n)
    — color buffers are None when the volume has no color planes."""
    hp = settings.hashing
    if cap is None:
        cap = hp.n_transfer_blocks
    mask = (swap_states == 2) & (vol.entry_ptr >= 0) & (visible_type == 0)
    ids = jnp.nonzero(mask, size=cap, fill_value=-1)[0].astype(jnp.int32)
    n = jnp.minimum(jnp.sum(mask), cap).astype(jnp.int32)
    return _evict_rows(vol, swap_states, ids, n, settings)


def evict_blocks_window(
    vol: HashVolume,
    swap_states: jnp.ndarray,
    visible_type: jnp.ndarray,
    settings: Settings,
    cap: int,
    window_idx: jnp.ndarray,
    n_windows: int = 16,
):
    """Rotating-window eviction for the pipelined exchange: scan only
    1/n_windows of the entry table per frame — a full [E]=1.18 M scan cost
    ~4 ms, 18× the typical eviction's worth of work. A block becomes
    evictable within n_windows frames of leaving the frustum (bounded
    latency; the reference scans everything every frame,
    buildListToSwapOut_device). MainEngine.flush_swap runs a final
    full-scan evict so checkpoints see every evictable block."""
    from infinitam_tpu.ops.hashing import compact_by_mask

    E = settings.hashing.n_entries
    W = -(-E // n_windows)
    off = (window_idx.astype(jnp.int32) % n_windows) * W
    ss_w = jax.lax.dynamic_slice(swap_states, (off,), (W,))
    ptr_w = jax.lax.dynamic_slice(vol.entry_ptr, (off,), (W,))
    vt_w = jax.lax.dynamic_slice(visible_type, (off,), (W,))
    mask = (ss_w == 2) & (ptr_w >= 0) & (vt_w == 0)
    local = jnp.arange(W, dtype=jnp.int32) + off
    ids, n = compact_by_mask(mask, local, cap, fill=jnp.int32(-1))
    n = jnp.minimum(n, cap)
    return _evict_rows(vol, swap_states, ids, n, settings)


def _evict_rows(vol, swap_states, ids, n, settings):
    hp = settings.hashing
    E = hp.n_entries
    B = vol.vox.shape[0]
    valid = ids >= 0
    ids_c = jnp.clip(ids, 0, E - 1)
    ptr = vol.entry_ptr[ids_c]
    ptr_c = jnp.where(valid, ptr, 0)

    from infinitam_tpu.engine.hash_volume import (
        VOX_INIT,
        rgb_clr_q,
        rgb_wc,
        vox_sdf_q,
        vox_w,
    )

    buf_vox = vol.vox[ptr_c]
    # host cache keeps the reference TVoxel plane layout (int16 sdf, uchar w)
    buf_sdf = vox_sdf_q(buf_vox).astype(jnp.int16)
    buf_w = vox_w(buf_vox).astype(jnp.uint8)

    # clear evicted blocks (reference clears to TVoxel() = sdf 1, w 0,
    # clr 0, w_color 0)
    scatter_idx = jnp.where(valid, ptr_c, B)
    vox = vol.vox.at[scatter_idx].set(
        jnp.full_like(buf_vox, VOX_INIT), mode="drop"
    )
    buf_clr = buf_wc = None
    vox_rgb = vol.vox_rgb
    if vol.vox_rgb is not None:
        buf_rgb = vol.vox_rgb[ptr_c]
        buf_clr = rgb_clr_q(buf_rgb).astype(jnp.uint8)
        buf_wc = rgb_wc(buf_rgb).astype(jnp.uint8)
        vox_rgb = vol.vox_rgb.at[scatter_idx].set(jnp.zeros_like(buf_rgb), mode="drop")

    # push blocks back on the free stack
    k = jnp.cumsum(valid.astype(jnp.int32)) - 1  # rank among evicted
    stack_idx = vol.last_free_block + 1 + k
    ok = valid & (stack_idx < hp.n_blocks)
    alloc_list = vol.alloc_list.at[jnp.where(ok, stack_idx, hp.n_blocks)].set(
        ptr_c, mode="drop"
    )
    n_freed = jnp.sum(ok).astype(jnp.int32)

    eidx = jnp.where(valid, ids_c, E)
    entry_ptr = vol.entry_ptr.at[eidx].set(-1, mode="drop")  # swapped out
    swap_states = swap_states.at[eidx].set(0, mode="drop")

    new_vol = vol._replace(
        vox=vox,
        vox_rgb=vox_rgb,
        alloc_list=alloc_list,
        last_free_block=vol.last_free_block + n_freed,
        entry_ptr=entry_ptr,
    )
    if vol.entry_grid is not None:
        from infinitam_tpu.engine.hash_volume import grid_cell

        cell, inb = grid_cell(vol.entry_pos[ids_c], settings.block_grid)
        G3 = vol.entry_grid.shape[0]
        cidx = jnp.where(valid & inb, cell, G3)
        new_vol = new_vol._replace(
            entry_grid=vol.entry_grid.at[cidx].set((ids_c << 1) | 1, mode="drop"),
            block_grid=vol.block_grid.at[cidx].set(-1, mode="drop"),
        )
    return new_vol, swap_states, ids, buf_sdf, buf_w, buf_clr, buf_wc, n


def swap_in_gather(cache: GlobalCache, ids_np: np.ndarray, with_color: bool):
    """Host half of IntegrateGlobalIntoLocal: gather the needed blocks from
    the host store. Pure numpy — callers run it while queued device programs
    execute (swap-in latency hiding). Returns
    (buf_sdf, buf_w, has, buf_clr, buf_wc) host arrays."""
    sel = np.clip(ids_np, 0, cache.stored_sdf.shape[0] - 1)
    has = cache.has_stored[sel] & (ids_np >= 0)
    buf_sdf = cache.stored_sdf[sel]
    buf_w = np.where(has[:, None], cache.stored_w[sel], 0)
    buf_clr = buf_wc = None
    if with_color and cache.stored_clr is not None:
        buf_clr = cache.stored_clr[sel]
        buf_wc = np.where(has[:, None], cache.stored_wc[sel], 0)
    return buf_sdf, buf_w, has, buf_clr, buf_wc


def swap_in(
    vol: HashVolume, swap_states: jnp.ndarray, cache: GlobalCache, settings: Settings
) -> Tuple[HashVolume, jnp.ndarray]:
    """IntegrateGlobalIntoLocal: device needed-list → host gather → merge
    (synchronous variant; MainEngine splits the gather off to overlap the
    raycast-prepare program)."""
    cap = settings.hashing.n_transfer_blocks
    ids, n = build_swap_in_list(swap_states, cap)
    n = int(n)
    if n == 0:
        # still must flip state 1→2 for zero entries? n==0 means none in state 1
        return vol, swap_states
    with_color = vol.vox_rgb is not None
    buf_sdf, buf_w, has, buf_clr, buf_wc = swap_in_gather(
        cache, np.asarray(ids), with_color
    )
    vol, swap_states = merge_swapped_in(
        vol,
        swap_states,
        ids,
        jnp.asarray(buf_sdf),
        jnp.asarray(buf_w),
        jnp.asarray(has),
        settings,
        buf_clr=None if buf_clr is None else jnp.asarray(buf_clr),
        buf_wc=None if buf_wc is None else jnp.asarray(buf_wc),
    )
    return vol, swap_states


def swap_out_device(
    vol: HashVolume,
    swap_states: jnp.ndarray,
    render_state: RenderStateVH,
    settings: Settings,
):
    """Device half of SaveToGlobalMemory: evict + clear + free-list return.
    Returns (vol, swap_states, host_job) — host_job is a closure that
    completes the host-store scatter. Call it AFTER dispatching the next
    device program (raycast prepare): the D2H readback and the numpy scatter
    then overlap device compute instead of sitting on the critical path
    (SURVEY §7 swap-latency hiding)."""
    vol, swap_states, ids, buf_sdf, buf_w, buf_clr, buf_wc, n = evict_blocks(
        vol, swap_states, render_state.visible_type, settings
    )
    # start the D2H copies immediately (async): when the pipelined caller
    # runs host_job a frame later, the data has landed and np.asarray does
    # not wait
    for a in (ids, buf_sdf, buf_w, buf_clr, buf_wc, n):
        if a is not None:
            a.copy_to_host_async()

    def host_job(cache: GlobalCache) -> None:
        n_ = int(n)
        if n_ == 0:
            return
        # Quantize the D2H transfer length to 256-block steps: a
        # Python-shaped device slice compiles one XLA program PER DISTINCT
        # LENGTH — with n varying every frame that would recompile every
        # frame. 16 length
        # variants max, each compiled once; steady frames move one 256-block
        # slab instead of the full transfer buffer.
        n_pad = min(ids.shape[0], -(-n_ // 256) * 256)
        ids_np = np.asarray(ids[:n_pad])[:n_]
        cache.stored_sdf[ids_np] = np.asarray(buf_sdf[:n_pad])[:n_]
        cache.stored_w[ids_np] = np.asarray(buf_w[:n_pad])[:n_]
        if buf_clr is not None and cache.stored_clr is not None:
            cache.stored_clr[ids_np] = np.asarray(buf_clr[:n_pad])[:n_]
            cache.stored_wc[ids_np] = np.asarray(buf_wc[:n_pad])[:n_]
        cache.has_stored[ids_np] = True

    return vol, swap_states, host_job


def swap_out(
    vol: HashVolume,
    swap_states: jnp.ndarray,
    render_state: RenderStateVH,
    cache: GlobalCache,
    settings: Settings,
) -> Tuple[HashVolume, jnp.ndarray]:
    """SaveToGlobalMemory: evict invisible device-newest blocks to the host
    store (synchronous variant; MainEngine uses swap_out_device + deferred
    host_job to overlap the host scatter with the raycast prepare)."""
    vol, swap_states, host_job = swap_out_device(
        vol, swap_states, render_state, settings
    )
    host_job(cache)
    return vol, swap_states


@partial(jax.jit, static_argnames=())
def mark_visible_for_swap(swap_states: jnp.ndarray, visible_type: jnp.ndarray) -> jnp.ndarray:
    """reference: buildVisibleList_device — visible entries not already
    device-newest need a swap-in check (state→1). In-flight entries (3,
    pipelined merge pending) are left alone — re-marking them would
    double-combine the stored content when both merges land."""
    return jnp.where(
        (visible_type > 0) & (swap_states != 2) & (swap_states != SWAP_IN_FLIGHT),
        1,
        swap_states,
    )


@partial(jax.jit, static_argnames=("settings",))
def reallocate_swapped_out(
    vol: HashVolume,
    visible_type: jnp.ndarray,
    settings: Settings,
    visible_ids: Optional[jnp.ndarray] = None,
) -> HashVolume:
    """reference: reAllocateSwappedOutVoxelBlocks_device — visible entries
    with ptr==−1 get a fresh block from the free list. With `visible_ids`
    (the compact visible list, which by construction contains every entry
    with visible_type>0) the scan runs over ≤V rows instead of all E."""
    hp = settings.hashing
    E = hp.n_entries
    if visible_ids is not None:
        ids_c = jnp.clip(visible_ids, 0, E - 1)
        need = (visible_ids >= 0) & (visible_type[ids_c] > 0) & (vol.entry_ptr[ids_c] == -1)
        rank = jnp.cumsum(need.astype(jnp.int32)) - 1
        list_idx = vol.last_free_block - rank
        ok = need & (list_idx >= 0)
        new_block = vol.alloc_list[jnp.clip(list_idx, 0, hp.n_blocks - 1)]
        idx = jnp.where(ok, ids_c, E)
    else:
        need = (visible_type > 0) & (vol.entry_ptr == -1)
        rank = jnp.cumsum(need.astype(jnp.int32)) - 1
        list_idx = vol.last_free_block - rank
        ok = need & (list_idx >= 0)
        new_block = vol.alloc_list[jnp.clip(list_idx, 0, hp.n_blocks - 1)]
        ids_c = jnp.arange(E, dtype=jnp.int32)
        idx = jnp.where(ok, ids_c, E)
    entry_ptr = vol.entry_ptr.at[idx].set(new_block, mode="drop")
    n_taken = jnp.sum(ok).astype(jnp.int32)
    out = vol._replace(entry_ptr=entry_ptr, last_free_block=vol.last_free_block - n_taken)
    if vol.entry_grid is not None:
        # flat component gathers
        idc = jnp.clip(idx, 0, E - 1)
        px = vol.entry_pos[:, 0][idc]
        py = vol.entry_pos[:, 1][idc]
        pz = vol.entry_pos[:, 2][idc]
        gp = settings.block_grid
        gx, gy, gz = gp.dims
        ox, oy, oz = gp.origin
        gxc = px - ox
        gyc = py - oy
        gzc = pz - oz
        inb = (
            (gxc >= 0) & (gxc < gx) & (gyc >= 0) & (gyc < gy)
            & (gzc >= 0) & (gzc < gz)
        )
        cell = (gxc * gy + gyc) * gz + gzc
        G3 = vol.entry_grid.shape[0]
        cidx = jnp.where(ok & inb, cell, G3)
        out = out._replace(
            entry_grid=vol.entry_grid.at[cidx].set(idc << 1, mode="drop"),
            block_grid=vol.block_grid.at[cidx].set(new_block, mode="drop"),
        )
    return out


def exchange_quantum(settings: Settings) -> int:
    """Fixed per-frame exchange slab size (blocks). One static size means
    the whole swap-mode frame compiles to ONE device program — a
    Python-shaped slice per distinct transfer length would cost a recompile
    and an extra dispatch. Entries beyond
    the quantum drip over subsequent frames (the reference's transfer
    buffer plays the same bounding role at 0x1000,
    ITMGlobalCache.h:18-40)."""
    return min(256, settings.hashing.n_transfer_blocks)


def evict_quantum(settings: Settings) -> int:
    """Per-frame EVICTION slab size (blocks) — deliberately smaller than the
    needed-list quantum: the eviction slabs are the only bulk D2H traffic on
    the per-frame path, and the host copies the WHOLE static buffer (96 KB
    at 64 blocks) asynchronously right after dispatch — no on-device
    slicing, no blocking wait. Entries beyond the quantum
    stay state 2 and drip over subsequent frames. (Sized for a slow
    host link; re-derive from the GPU trace — ROADMAP S6.)"""
    return min(64, settings.hashing.n_transfer_blocks)


class SwapExchange:
    """Pipelined host↔device swap exchange.

    The reference's synchronous per-frame exchange
    (ITMSwappingEngine_CUDA.cu:42-296) is re-staged around three rules:
    never block on a current-frame device value, never add a dispatch the
    non-swap path doesn't have, and never move more bytes than the frame's
    actual exchange:

    - The device half (needed-list resolution → fuse → list build →
      rotating-window evict) is FUSED into the frame program
      (hash_pipeline.step_frame_swap).
    - Steady-state traffic is two ~1 KB metadata copies (list ids+count)
      per frame, started async by the program's outputs. Eviction slabs
      stay device-side until the count lands (stage B a frame later), then
      copy quantized to the actual eviction; needed-block uploads carry
      only rows with stored data (usually none — freshly allocated blocks
      have nothing stored, matching the reference's has-data no-op merge).
    - The host halves executed each frame belong to earlier frames whose
      copies landed: numpy gathers/scatters only.

    End-to-end lag: a needed block's stored content merges ≤2 frames after
    listing (listed entries hold the in-flight state 3 so they cannot
    re-list or evict meanwhile); evictions reach the store ≤2 frames after
    the window scan picks them. flush() drains everything (checkpoint
    save / shutdown); MainEngine.flush_swap adds a final full-scan evict.
    """

    _DQ = 64  # data-slab row quantum (bounds merge-program shape variants)

    def __init__(self, settings: Settings, with_color: bool):
        self.settings = settings
        self.with_color = with_color
        # request queues: metas are consumed only after PIPE_DEPTH newer
        # frames were dispatched, so the host never blocks on the
        # immediately-preceding program (the wait would serialize the
        # host-device pipeline to depth 1 and cap throughput below the
        # device rate)
        self._in_q = []  # [Q+1] metas — copies in flight
        self._out_q = []  # (ev_meta, slabs...) — copies in flight
        self._merge_flips = None  # [Q] device ids for the next dispatch
        self._merge_slab = None  # data slab for the next dispatch

    def merge_args(self):
        """(merge_flips, merge_slab) operands for this frame's
        step_frame_swap dispatch (None, None when nothing is pending)."""
        return self._merge_flips, self._merge_slab

    PIPE_DEPTH = 2  # frames a meta waits before the host reads it

    def after_frame(self, in_meta, out_pack, cache: GlobalCache):
        """Called after the frame's device programs are dispatched: start
        the metadata AND eviction-slab copies (whole static buffers — an
        on-device slice would be an extra dispatch and its copy could not
        start until the slice ran),
        then complete EARLIER frames' host halves on landed data (numpy
        only — overlaps the device queue). A buffer is read only after
        PIPE_DEPTH newer frames were dispatched, so the read never waits
        on the device."""
        in_meta.copy_to_host_async()
        for a in out_pack:
            if a is not None:
                a.copy_to_host_async()
        self._in_q.append(in_meta)
        self._out_q.append(out_pack)
        self._merge_flips = None
        self._merge_slab = None
        # eviction scatter: an old frame's slabs landed → numpy only
        if len(self._out_q) > self.PIPE_DEPTH:
            ev_meta, sdf, w, clr, wc = self._out_q.pop(0)
            meta = np.asarray(ev_meta)  # landed
            n_ = int(meta[-1])
            if n_ > 0:
                ids_np = meta[:n_]
                cache.stored_sdf[ids_np] = np.asarray(sdf)[:n_]
                cache.stored_w[ids_np] = np.asarray(w)[:n_]
                if clr is not None and cache.stored_clr is not None:
                    cache.stored_clr[ids_np] = np.asarray(clr)[:n_]
                    cache.stored_wc[ids_np] = np.asarray(wc)[:n_]
                cache.has_stored[ids_np] = True
        # swap-in: an old frame's needed list landed → resolve it next frame
        if len(self._in_q) > self.PIPE_DEPTH:
            meta_dev = self._in_q.pop(0)
            meta = np.asarray(meta_dev)  # landed
            n_ = int(meta[-1])
            if n_ > 0:
                ids_np = meta[:-1]
                # the flip list is the meta's own device buffer — no upload
                # (step_frame_swap slices off the count row in-program)
                self._merge_flips = meta_dev
                bs, bw, has, bc, bwc = swap_in_gather(
                    cache, ids_np, self.with_color
                )
                d_eff = int(has.sum())
                if d_eff > 0:
                    self._merge_slab = self._pack_data_slab(
                        ids_np, bs, bw, has, bc, bwc, d_eff
                    )

    def _pack_data_slab(self, ids_np, bs, bw, has, bc, bwc, d_eff):
        """Pack the has-data rows into a [D(+D)+1, S³] int32 slab (D
        quantized to _DQ — bounded shape variants, each compiled once)."""
        s3 = self.settings.hashing.block_volume
        D = min(bs.shape[0], -(-d_eff // self._DQ) * self._DQ)
        sel = np.nonzero(has)[0][:D]
        rows = (2 * D if self.with_color else D) + 1
        slab = np.zeros((rows, s3), dtype=np.int32)
        k = len(sel)
        slab[:k] = ((bs[sel].astype(np.int32) & 0xFFFF) << 16) | (
            (bw[sel].astype(np.int32) & 0xFF) << 8
        )
        slab[k:D] = 0x7FFF0000  # pack_vox(sdf=+1, w=0) — no-op rows
        if self.with_color and bc is not None:
            slab[D:D + k] = (
                (bc[sel][..., 0].astype(np.int32) << 24)
                | (bc[sel][..., 1].astype(np.int32) << 16)
                | (bc[sel][..., 2].astype(np.int32) << 8)
                | bwc[sel].astype(np.int32)
            )
        slab[-1, :k] = ids_np[sel]
        slab[-1, k:] = -1
        return jnp.asarray(slab)

    def flush(self, vol: HashVolume, swap_states: jnp.ndarray,
              cache: GlobalCache):
        """Drain every stage synchronously (checkpoint save / shutdown)."""
        q = exchange_quantum(self.settings)
        s3 = self.settings.hashing.block_volume
        E = swap_states.shape[0]
        for _ in range(self.PIPE_DEPTH + 3):
            flips, slab = self.merge_args()
            if flips is not None:
                f = flips[:-1]  # meta-shaped: last row is the count
                swap_states = swap_states.at[
                    jnp.where(f >= 0, f, E)
                ].set(2, mode="drop")
            if slab is not None:
                vol, swap_states = merge_data_slab(
                    vol, swap_states, slab, self.settings,
                    with_color=self.with_color and vol.vox_rgb is not None,
                )
            empty_meta = jnp.full((q + 1,), -1, jnp.int32).at[-1].set(0)
            zero = jnp.zeros((1, s3), jnp.int32)
            self.after_frame(
                empty_meta,
                (empty_meta, zero.astype(jnp.int16),
                 zero.astype(jnp.uint8), None, None),
                cache,
            )
        self._in_q = []
        self._out_q = []
        self._merge_flips = None
        self._merge_slab = None
        return vol, swap_states
