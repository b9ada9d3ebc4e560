"""End-to-end per-frame pipeline on the voxel-block-hash volume.

The reference's default configuration (ITMVoxelIndex=ITMVoxelBlockHash,
ITMLibDefines.h:206-211). Orchestration parity:
- ITMDenseMapper::ProcessFrame (ITMDenseMapper.cpp:51-65):
  AllocateSceneFromDepth → IntegrateIntoScene (→ swap in/out when enabled)
- ITMSceneReconstructionEngine_CUDA.cu:89-230 (alloc/integrate kernels)
- ITMTrackingController::Prepare → CreateExpectedDepths + CreateICPMaps

Integration gathers the visible blocks into a dense [V, 512]-voxel batch,
runs ONE fused elementwise update, and scatters back; allocation is the
scatter/cumsum protocol in hash_volume.py.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from infinitam_tpu.config import Settings
from infinitam_tpu.engine import hash_volume as hv
from infinitam_tpu.engine.hash_volume import HashVolume, RenderStateVH
from infinitam_tpu.engine.tracking_state import TrackingState, create_tracking_state
from infinitam_tpu.engine.trackers import TrackResult, track_depth
from infinitam_tpu.engine.view_builder import View
from infinitam_tpu.ops import hashing
from infinitam_tpu.ops import raycast as rc
from infinitam_tpu.ops import tsdf
from infinitam_tpu.utils import se3

# cap on the ±mu band DDA steps (band_steps() derives the exact per-config
# count; the cap guards degenerate configs with mu ≫ block edge)
MAX_BAND_STEPS = 6

# static capacity for out-of-working-grid allocation candidates per frame
# (typically zero; candidates beyond the cap defer to the next frame)
OOG_CAP = 2048


def band_steps(settings: Settings) -> int:
    """Exact static DDA step count for the ±mu allocation band: a segment of
    length 2·mu crosses at most ceil(2·mu/edge) planes per axis, touching
    1 + 3·ceil cells. Every shipped config has 2·mu == one block edge → 4
    steps (the round-4 fixed 6 oversized the candidate plane 1.5×; every
    candidate-space op scales with it)."""
    import math

    edge = settings.hashing.block_size * settings.scene.voxel_size
    ratio = 2.0 * settings.scene.mu / edge
    return min(MAX_BAND_STEPS, 1 + 3 * max(1, math.ceil(ratio - 1e-6)))


def novel_cap(settings: Settings) -> int:
    """Static capacity of the compacted novel-candidate stage (allocator
    stage 2): survivors of the neighbour dedupe, ~2-3× the unique touched
    cells. 2× the visible-list capacity holds comfortably; overflow defers
    to the next frame and is counted in n_alloc_overflow."""
    return max(2 * settings.hashing.max_visible_blocks, 4096)


class FrameDiagnostics(NamedTuple):
    f: jnp.ndarray
    num_valid: jnp.ndarray
    n_visible: jnp.ndarray
    n_free_blocks: jnp.ndarray
    # silent-cap counters (SURVEY §5 "no silent caps" hygiene) — all ~0 on a
    # healthy scene; nonzero values mean the frame degraded gracefully:
    # new blocks that deferred to the next frame (alloc cap / free-list dry)
    n_alloc_overflow: jnp.ndarray = jnp.int32(0)
    # visible blocks beyond the expected-depth raster cap (range image loose)
    n_render_overflow: jnp.ndarray = jnp.int32(0)
    # visible blocks whose projected bbox exceeded the expected-depth raster
    # tile (left out of the ranges; their pixels march only where other
    # blocks cover them)
    n_too_big_blocks: jnp.ndarray = jnp.int32(0)


def allocate_scene_from_depth(
    vol: HashVolume,
    render_state: RenderStateVH,
    depth: jnp.ndarray,
    pose: jnp.ndarray,
    proj: jnp.ndarray,
    settings: Settings,
    only_update_visible: bool = False,
    enable: jnp.ndarray | bool = True,
) -> Tuple[HashVolume, RenderStateVH, jnp.ndarray]:
    """AllocateSceneFromDepth (reference: _CUDA.cu:89-170): plan from the
    depth band → allocate → rebuild the compacted visible list. `enable=False`
    (dynamic) suppresses new allocations (divergence policy) while still
    refreshing visibility.

    Fully-compact design (no per-frame op scans the [G³] plane, let alone
    an [E] one — every stage is candidate-space):

      1. ±mu band DDA → candidate cells [steps·P] (P = subsampled pixels).
      2. NEIGHBOUR DEDUPE: a candidate equal to any candidate of the
         left/up/up-left pixel is dropped (blocks span ≥2 allocation strides,
         so ~80-90% of candidates duplicate a neighbour; equality chains
         terminate at a surviving first occurrence, so cell coverage is
         exact). Survivors compact to a C2-sized stage (cumsum + scatter).
      3. EXACT DEDUPE: survivors claim their cell in the persistent [G³]
         cell_claim plane (scatter row index, gather back, winner = rows
         that read their own index). One winner per touched cell; winners
         compact to the ≤Vcap unique-cell list. The plane is never cleared:
         cells touched this frame always hold a fresh claim, and claims are
         validated against the claiming row, so stale values are inert.
      4. Winner cells tap the incremental entry grid: cells with entries are
         visible (k-rows, already compact at list offset 0); cells without
         are the frame's allocation wants (insert under a cond — steady-state
         frames allocate nothing). Out-of-grid candidates fall back to hash
         probing under their own cond, with the found rows sort-deduped
         (duplicate OOG rows would double-fuse and leak swap blocks).
      5. Last frame's visibles re-check by projection over the compact list
         (reference setToType3 + buildVisibleList semantics), deduped via
         the claim plane + entry epochs, and appended at offset n_k; OOG
         rows append after them. No concat-then-scan: three offset scatters.

    Returns (vol, render_state, n_alloc_overflow) — the third value counts
    wanted-but-deferred new blocks (alloc/novel/OOG cap overflow)."""
    if render_state.cell_claim is None or vol.entry_grid is None:
        return _allocate_scene_from_depth_legacy(
            vol, render_state, depth, pose, proj, settings,
            only_update_visible=only_update_visible, enable=enable,
        )
    hp = settings.hashing
    sp = settings.scene
    img_size = depth.shape
    E = hp.n_entries
    gp = settings.block_grid
    gx, gy, gz = gp.dims
    G3 = gx * gy * gz
    Vcap = hp.max_visible_blocks
    epoch = render_state.epoch + 1
    use_swapping = settings.swapping_mode.value == "enabled"

    s = settings.alloc_subsample
    depth_a = depth[::s, ::s] if s > 1 else depth
    proj_a = proj / s if s > 1 else proj
    Ph, Pw = depth_a.shape
    nsteps = band_steps(settings)

    cbx, cby, cbz, cval = hashing.blocks_on_ray_segment_planes(
        depth_a, proj_a, se3.invert(pose), sp.mu, sp.voxel_size,
        hp.block_size, nsteps, sp.view_frustum_min, sp.view_frustum_max,
    )  # each [nsteps, Ph·Pw]
    cval = cval & enable

    ox, oy, oz = gp.origin
    gxc = cbx - ox
    gyc = cby - oy
    gzc = cbz - oz
    in_grid = (
        (gxc >= 0) & (gxc < gx) & (gyc >= 0) & (gyc < gy) & (gzc >= 0) & (gzc < gz)
    )
    cell = (gxc * gy + gyc) * gz + gzc  # [nsteps, Ph·Pw]

    # --- stage 2: neighbour dedupe + compact ------------------------------
    key = jnp.where(cval & in_grid, cell, -1).reshape(nsteps, Ph, Pw)

    def _matches_any(shifted):  # [nsteps, Ph, Pw] vs all steps of a neighbour
        m = jnp.zeros(key.shape, dtype=bool)
        for s2 in range(nsteps):
            nb = shifted[s2][None]
            m |= (key == nb) & (nb >= 0)
        return m

    left = jnp.pad(key[:, :, :-1], ((0, 0), (0, 0), (1, 0)), constant_values=-1)
    up = jnp.pad(key[:, :-1, :], ((0, 0), (1, 0), (0, 0)), constant_values=-1)
    upleft = jnp.pad(
        key[:, :-1, :-1], ((0, 0), (1, 0), (1, 0)), constant_values=-1
    )
    dup_nb = _matches_any(left) | _matches_any(up) | _matches_any(upleft)
    novel = (key >= 0) & ~dup_nb
    novel_flat = novel.reshape(-1)
    C2 = novel_cap(settings)
    c2_cell, n_novel = hashing.compact_by_mask(
        novel_flat, jnp.where(novel_flat, cell.reshape(-1), G3), C2, fill=G3
    )
    novel_overflow = jnp.maximum(n_novel - C2, 0)

    # --- stage 3: exact dedupe via the claim plane ------------------------
    iota2 = jnp.arange(C2, dtype=jnp.int32)
    cell_claim = render_state.cell_claim.at[
        jnp.where(c2_cell < G3, c2_cell, G3)
    ].set(iota2, mode="drop")
    win = (c2_cell < G3) & (cell_claim[jnp.clip(c2_cell, 0, G3 - 1)] == iota2)
    kcell, n_k_total = hashing.compact_by_mask(win, c2_cell, Vcap, fill=G3)
    k_overflow = jnp.maximum(n_k_total - Vcap, 0)
    n_k = jnp.minimum(n_k_total, Vcap)
    kvalid = kcell < G3
    kcell_c = jnp.clip(kcell, 0, G3 - 1)

    # --- out-of-grid candidates (hash fallback; unbounded world) ----------
    # cond-gated INCLUDING the candidate compaction (a nonzero over the full
    # candidate plane costs >1 ms; typical frames have zero OOG candidates).
    oog = (cval & ~in_grid).reshape(-1)
    n_oog = jnp.sum(oog).astype(jnp.int32)
    entry_epoch = render_state.entry_epoch
    cbx_f = cbx.reshape(-1)
    cby_f = cby.reshape(-1)
    cbz_f = cbz.reshape(-1)

    def _oog_candidates():
        oidx = jnp.nonzero(oog, size=OOG_CAP, fill_value=-1)[0]
        oc = jnp.clip(oidx, 0, cbx_f.shape[0] - 1)
        ocand = jnp.stack([cbx_f[oc], cby_f[oc], cbz_f[oc]], axis=-1)
        return ocand, oidx >= 0

    def probe_oog(ee):
        ocand, ovalid = _oog_candidates()
        opr = hv.probe(vol, ocand, hp, include_swapped=True)
        ofound = ovalid & opr.found
        oe = jnp.where(ofound, opr.entry_idx, E)
        ee = ee.at[oe].set(epoch, mode="drop")
        ocode = jnp.where(
            opr.entry_ptr == hv.SWAPPED_PTR, hv.VT_VISIBLE_SWAPPED, hv.VT_VISIBLE
        )
        ocode = jnp.where(ofound, ocode, 0)
        # sort-dedupe the found rows: many band candidates probing the same
        # entry would each contribute a duplicate visible row — double-fusing
        # the block and popping one swap-realloc slot per duplicate. 2k-row
        # argsort, cond-gated.
        order = jnp.argsort(oe)
        oe_s = oe[order]
        ocode_s = ocode[order]
        first = jnp.concatenate(
            [jnp.ones((1,), bool), oe_s[1:] != oe_s[:-1]]
        ) & (oe_s < E)
        oe_d = jnp.where(first, oe_s, E)
        ocode_d = jnp.where(first, ocode_s, 0)
        n_new = jnp.sum(ovalid & ~opr.found).astype(jnp.int32)
        return ee, oe_d, ocode_d, opr.found, n_new

    entry_epoch, oog_vis_idx, oog_vis_code, oog_found, n_oog_new = jax.lax.cond(
        n_oog > 0,
        probe_oog,
        lambda ee: (
            ee,
            jnp.full((OOG_CAP,), E, jnp.int32),
            jnp.zeros((OOG_CAP,), jnp.int32),
            jnp.ones((OOG_CAP,), bool),
            jnp.int32(0),
        ),
        entry_epoch,
    )
    oog_new_idx = jnp.full((OOG_CAP,), E, jnp.int32)

    n_alloc_overflow = novel_overflow + k_overflow
    if not only_update_visible:
        # allocation wants: winner cells with no entry yet. Only the cheap
        # Vcap-sized reduce runs every frame; the compaction + decode +
        # insert live in the cond (steady-state frames allocate nothing —
        # the reference analogue is the per-entry alloc kernel with nothing
        # marked, _CUDA.cu:149).
        packed0 = vol.entry_grid[kcell_c]
        want = kvalid & (packed0 < 0)
        n_want = jnp.sum(want).astype(jnp.int32)
        n_alloc_overflow = n_alloc_overflow + jnp.maximum(
            n_want - settings.max_alloc_blocks, 0
        ) + jnp.maximum(n_oog - OOG_CAP, 0)
        dummy_vt = jnp.zeros((1,), jnp.int32)  # codes tracked compactly here

        def do_insert_grid(op):
            v, ee = op
            ncell, _ = hashing.compact_by_mask(
                want, kcell, settings.max_alloc_blocks, fill=G3
            )
            nv = ncell < G3
            ncell_c = jnp.clip(ncell, 0, G3 - 1)
            nblocks = jnp.stack(
                [ncell_c // (gy * gz), (ncell_c // gz) % gy, ncell_c % gz], axis=-1
            ).astype(jnp.int32) + jnp.array(gp.origin, dtype=jnp.int32)
            v, _, _ = hv.insert_blocks(v, dummy_vt, nblocks, nv, hp, grid_params=gp)
            # round 2 on the same set: same-bucket losers of round 1
            # (distinct blocks electing one winner per chain tail) insert now
            # instead of deferring a frame — removes the reference's
            # first-frame pinholes (insert_blocks re-probes, so
            # already-inserted blocks are no-ops)
            v, _, _ = hv.insert_blocks(v, dummy_vt, nblocks, nv, hp, grid_params=gp)
            return v, ee

        def do_insert_oog(op):
            v, ee, _ow = op
            ocand, ovalid = _oog_candidates()
            v, _, owidx = hv.insert_blocks(
                v, dummy_vt, ocand, ovalid & ~oog_found, hp, grid_params=gp
            )
            return v, ee.at[owidx].set(epoch, mode="drop"), owidx

        # The voxel planes don't flow through the conds — insert never
        # touches them and carrying 134 MB through both branches costs real
        # HBM traffic.
        slim = vol._replace(vox=jnp.zeros((1, 1), jnp.int32), vox_rgb=None)
        slim, entry_epoch = jax.lax.cond(
            n_want > 0, do_insert_grid, lambda op: op, (slim, entry_epoch)
        )
        slim, entry_epoch, oog_new_idx = jax.lax.cond(
            n_oog_new > 0,
            do_insert_oog,
            lambda op: op,
            (slim, entry_epoch, oog_new_idx),
        )
        vol = slim._replace(vox=vol.vox, vox_rgb=vol.vox_rgb)
        # freshly inserted OOG entries join the visible rows as their own
        # list (code 1); insert_blocks elects one winner per duplicate
        # candidate, so winner rows are already unique
        oog_new_idx = jnp.where(oog_new_idx < E, oog_new_idx, E)

    # --- visible-list rows ------------------------------------------------
    # k-rows: winner cells that (now) have an entry — already compact at
    # offset 0 (freshly inserted blocks included: insert updates entry_grid).
    # Cells whose allocation deferred leave a −1 gap (rare; consumers mask).
    packed = vol.entry_grid[kcell_c]
    k_live = kvalid & (packed >= 0)
    k_eidx = jnp.where(k_live, packed >> 1, -1)
    k_code = jnp.where((packed & 1) == 1, hv.VT_VISIBLE_SWAPPED, hv.VT_VISIBLE)
    n_k_eff = jnp.sum(k_live).astype(jnp.int32)

    # prev-rows: last frame's visibles, projection re-check over the compact
    # list (reference: setToType3 + buildVisibleList type-3 re-check),
    # deduped via the claim plane (cell touched this frame ⇒ already a k-row)
    # + entry epochs (OOG rows). Positions come as three flat gathers.
    pid = render_state.visible_ids
    pidc = jnp.clip(pid, 0, E - 1)
    pvalid = pid >= 0
    ppx = vol.entry_pos[:, 0][pidc]
    ppy = vol.entry_pos[:, 1][pidc]
    ppz = vol.entry_pos[:, 2][pidc]
    pvis = hv.check_block_visibility_planes(
        ppx, ppy, ppz, pose, proj, img_size, sp.voxel_size, hp.block_size,
        enlarged=use_swapping,
    )
    pgx = ppx - ox
    pgy = ppy - oy
    pgz = ppz - oz
    pinb = (
        (pgx >= 0) & (pgx < gx) & (pgy >= 0) & (pgy < gy)
        & (pgz >= 0) & (pgz < gz)
    )
    pcell = (pgx * gy + pgy) * gz + pgz
    jclaim = cell_claim[jnp.clip(pcell, 0, G3 - 1)]
    dup_cell = pinb & (
        c2_cell[jnp.clip(jclaim, 0, C2 - 1)] == pcell
    ) & (jclaim >= 0) & (jclaim < C2)
    dup = dup_cell | (entry_epoch[pidc] == epoch)
    keep_prev = pvalid & pvis & ~dup

    # --- assembly: three offset scatters, no concat-then-scan -------------
    ids = k_eidx.astype(jnp.int32)  # [Vcap], k-rows at offset 0
    prev_pos = jnp.cumsum(keep_prev.astype(jnp.int32)) - 1
    pdst = n_k + prev_pos
    ids = ids.at[jnp.where(keep_prev & (pdst < Vcap), pdst, Vcap)].set(
        pidc, mode="drop"
    )
    n_prev = jnp.sum(keep_prev).astype(jnp.int32)
    om_f = oog_vis_idx < E
    om_n = oog_new_idx < E
    o_pos = jnp.cumsum(om_f.astype(jnp.int32)) - 1
    odst = n_k + n_prev + o_pos
    ids = ids.at[jnp.where(om_f & (odst < Vcap), odst, Vcap)].set(
        oog_vis_idx, mode="drop"
    )
    n_oog_f = jnp.sum(om_f).astype(jnp.int32)
    on_pos = jnp.cumsum(om_n.astype(jnp.int32)) - 1
    ondst = n_k + n_prev + n_oog_f + on_pos
    ids = ids.at[jnp.where(om_n & (ondst < Vcap), ondst, Vcap)].set(
        oog_new_idx, mode="drop"
    )
    n_oog_v = n_oog_f + jnp.sum(om_n).astype(jnp.int32)
    # true visible count (uncapped — _frame_diag compares it against the
    # render/page windows so cap overflows surface there)
    n_visible = n_k_eff + n_prev + n_oog_v

    # swapping needs the reference's full [E] visible_type plane (evict tests
    # visible_type==0 over all entries); maintain it by clearing last frame's
    # marks and scattering this frame's codes — ≤V-sized scatters, swap
    # mode only. Non-swap mode carries the plane untouched (stale, unused).
    vt = render_state.visible_type
    if use_swapping:
        vt = vt.at[jnp.where(pvalid, pidc, E)].set(0, mode="drop")
        vt = vt.at[jnp.where(k_live, k_eidx, E)].set(k_code, mode="drop")
        vt = vt.at[jnp.where(keep_prev, pidc, E)].set(
            hv.VT_VISIBLE_PREVIOUS, mode="drop"
        )
        vt = vt.at[jnp.where(om_f, oog_vis_idx, E)].set(oog_vis_code, mode="drop")
        vt = vt.at[jnp.where(om_n, oog_new_idx, E)].set(hv.VT_VISIBLE, mode="drop")

    new_rs = RenderStateVH(
        visible_type=vt,
        visible_ids=ids,
        n_visible=n_visible,
        cell_claim=cell_claim,
        entry_epoch=entry_epoch,
        epoch=epoch,
    )
    return vol, new_rs, n_alloc_overflow


def _allocate_scene_from_depth_legacy(
    vol: HashVolume,
    render_state: RenderStateVH,
    depth: jnp.ndarray,
    pose: jnp.ndarray,
    proj: jnp.ndarray,
    settings: Settings,
    only_update_visible: bool = False,
    enable: jnp.ndarray | bool = True,
) -> Tuple[HashVolume, RenderStateVH, jnp.ndarray]:
    """Oracle allocator over the full visible_type plane (reference-shaped:
    setToType3 → plan → allocate → buildVisibleList). Used when the volume
    has no grid caches; also the property-test oracle for the compact path."""
    hp = settings.hashing
    sp = settings.scene
    img_size = depth.shape

    E = hp.n_entries
    visible_type = hv.set_previous_visible(render_state)

    # Allocation rays from a subsampled depth grid: a block spans ~8+ pixels,
    # so a stride-s grid still touches every surface block (and the DDA below
    # is exact per ray) at 1/s² the probe cost. The reference marches every
    # pixel (buildHashAllocAndVisibleType_device).
    s = settings.alloc_subsample
    depth_a = depth[::s, ::s] if s > 1 else depth
    proj_a = proj / s if s > 1 else proj

    blocks, valid = hashing.blocks_on_ray_segment(
        depth_a,
        proj_a,
        se3.invert(pose),
        sp.mu,
        sp.voxel_size,
        hp.block_size,
        MAX_BAND_STEPS,
        sp.view_frustum_min,
        sp.view_frustum_max,
    )
    cand = blocks.reshape(-1, 3)
    cand_valid = valid.reshape(-1) & enable

    # Candidate-space allocation (redesign of
    # buildHashAllocAndVisibleType + allocateVoxelBlocksList, reference
    # _CUDA.cu:350-415): instead of hash-probing every candidate (4-link
    # chain gathers × |cand|), candidates tap the dense
    # entry grid once; only the few-k NEW cells (deduped via a want-plane
    # scatter) and the rare out-of-grid candidates reach the hash.
    gp = settings.block_grid
    gx, gy, gz = gp.dims
    G3 = gx * gy * gz
    origin = jnp.array(gp.origin, dtype=jnp.int32)
    g = cand - origin
    in_grid = (
        (g[:, 0] >= 0) & (g[:, 0] < gx)
        & (g[:, 1] >= 0) & (g[:, 1] < gy)
        & (g[:, 2] >= 0) & (g[:, 2] < gz)
    )
    cell = (g[:, 0] * gy + g[:, 1]) * gz + g[:, 2]
    # the incrementally-maintained cache kills the per-frame [E]-scatter
    # rebuild (9 ms at reference capacities)
    entry_grid = vol.entry_grid if vol.entry_grid is not None else hv.build_entry_grid(vol, gp)
    code = entry_grid[jnp.clip(cell, 0, G3 - 1)]
    known = cand_valid & in_grid & (code >= 0)

    # visibility marks for known entries: 2 if swapped out, 1 otherwise
    eidx = code >> 1
    vis_val = jnp.where((code & 1) == 1, hv.VT_VISIBLE_SWAPPED, hv.VT_VISIBLE)
    visible_type = visible_type.at[jnp.where(known, eidx, E)].set(
        jnp.where(known, vis_val, 0), mode="drop"
    )

    # out-of-grid candidates fall back to hash probing (unbounded world —
    # the grid is an accelerator, the hash stays canonical). The probe and
    # insert are lax.cond-gated: on a typical frame every candidate lands in
    # the working grid and the whole OOG machinery is skipped at runtime.
    oog = cand_valid & ~in_grid
    n_oog = jnp.sum(oog).astype(jnp.int32)
    oidx = jnp.nonzero(oog, size=OOG_CAP, fill_value=-1)[0]
    ocand = cand[jnp.clip(oidx, 0, cand.shape[0] - 1)]
    ovalid = oidx >= 0

    def probe_oog(vt):
        opr = hv.probe(vol, ocand, hp, include_swapped=True)
        ofound = ovalid & opr.found
        ovis = jnp.where(
            opr.entry_ptr == hv.SWAPPED_PTR, hv.VT_VISIBLE_SWAPPED, hv.VT_VISIBLE
        )
        vt = vt.at[jnp.where(ofound, opr.entry_idx, E)].set(
            jnp.where(ofound, ovis, 0), mode="drop"
        )
        return vt, opr.found

    visible_type, oog_found = jax.lax.cond(
        n_oog > 0, probe_oog, lambda vt: (vt, jnp.ones_like(ovalid)), visible_type
    )

    n_alloc_overflow = jnp.int32(0)
    if not only_update_visible:
        # new in-grid cells: dedupe via a want-plane, compact, insert once
        want_at = jnp.where(cand_valid & in_grid & (code < 0), cell, G3)
        want = jnp.zeros((G3 + 1,), jnp.bool_).at[want_at].set(True, mode="drop")
        n_want = jnp.sum(want[:G3]).astype(jnp.int32)
        n_alloc_overflow = jnp.maximum(n_want - settings.max_alloc_blocks, 0) + jnp.maximum(
            n_oog - OOG_CAP, 0
        )
        ncell = jnp.nonzero(want[:G3], size=settings.max_alloc_blocks, fill_value=-1)[0]
        ncell_c = jnp.clip(ncell, 0, G3 - 1)
        nblocks = jnp.stack(
            [ncell_c // (gy * gz), (ncell_c // gz) % gy, ncell_c % gz], axis=-1
        ).astype(jnp.int32) + origin

        def do_insert_grid(op):
            v, vt = op
            v, vt, _ = hv.insert_blocks(v, vt, nblocks, ncell >= 0, hp, grid_params=gp)
            # round 2 on the same set: same-bucket losers of round 1
            # (distinct blocks electing one winner per chain tail) insert now
            # instead of deferring a frame — removes the reference's
            # first-frame pinholes (insert_blocks re-probes, so
            # already-inserted blocks are no-ops)
            v, vt, _ = hv.insert_blocks(v, vt, nblocks, ncell >= 0, hp, grid_params=gp)
            return v, vt

        def do_insert_oog(op):
            v, vt = op
            v, vt, _ = hv.insert_blocks(v, vt, ocand, ovalid & ~oog_found, hp, grid_params=gp)
            return v, vt

        # steady-state frames have zero new blocks: the cond skips the
        # probe + election + scatter cost entirely (reference analogue: the
        # per-entry alloc kernel has nothing marked, _CUDA.cu:149). The voxel
        # planes don't flow through the cond — insert never touches them and
        # carrying 134 MB through both branches costs real HBM traffic.
        slim = vol._replace(vox=jnp.zeros((1, 1), jnp.int32), vox_rgb=None)
        slim, visible_type = jax.lax.cond(
            n_want > 0, do_insert_grid, lambda op: op, (slim, visible_type)
        )
        slim, visible_type = jax.lax.cond(
            jnp.any(ovalid & ~oog_found), do_insert_oog, lambda op: op, (slim, visible_type)
        )
        vol = slim._replace(vox=vol.vox, vox_rgb=vol.vox_rgb)

    use_swapping = settings.swapping_mode.value == "enabled"
    new_rs = hv.build_visible_list(
        vol, visible_type, pose, proj, img_size, sp.voxel_size, hp,
        use_enlarged=use_swapping,
        prev_ids=render_state.visible_ids,
    )
    return vol, new_rs, n_alloc_overflow


def integrate_into_scene(
    vol: HashVolume,
    render_state: RenderStateVH,
    view: View,
    pose: jnp.ndarray,
    proj: jnp.ndarray,
    settings: Settings,
    proj_rgb: jnp.ndarray | None = None,
    rgb_to_depth: jnp.ndarray | None = None,
    enable: jnp.ndarray | bool = True,
) -> HashVolume:
    """IntegrateIntoScene (reference: integrateIntoScene_device — grid over
    visible blocks × 8³ threads): gather → fused TSDF update → scatter.
    `enable=False` (dynamic) makes the update a no-op (divergence policy)."""
    hp = settings.hashing
    sp = settings.scene
    S = hp.block_size
    S3 = hp.block_volume
    B = vol.vox.shape[0]

    ids = render_state.visible_ids  # [V]
    # Work proportional to visibility: the reference launches
    # <<<noVisibleEntries, 8³>>> (ITMSceneReconstructionEngine_CUDA.cu:206);
    # here the static analogue is a cap on the gathered block count. Blocks
    # beyond the cap (rare; visible counts are far below it) stay unfused
    # this frame and catch up on a later one.
    if settings.max_fused_blocks and settings.max_fused_blocks < ids.shape[0]:
        ids = ids[: settings.max_fused_blocks]
    ids_c = jnp.clip(ids, 0, hp.n_entries - 1)
    ptr = vol.entry_ptr[ids_c]  # [V]
    bpos = vol.entry_pos[ids_c]  # [V, 3]
    valid = (ids >= 0) & (ptr >= 0)
    ptr_c = jnp.where(valid, ptr, 0)

    # world positions of every voxel in every visible block
    lin = jnp.arange(S3, dtype=jnp.int32)
    lx = lin % S
    ly = (lin // S) % S
    lz = lin // (S * S)
    local = jnp.stack([lx, ly, lz], axis=-1)  # [S³, 3]
    gvox = bpos[:, None, :] * S + local[None, :, :]  # [V, S³, 3]
    pt_world = gvox.astype(jnp.float32) * sp.voxel_size

    old_vox = vol.vox[ptr_c]  # [V, S³] packed — ONE gather
    old_sdf = hv.vox_sdf(old_vox)
    old_w = hv.vox_w(old_vox)

    with_color = settings.use_color and view.rgb is not None and vol.vox_rgb is not None
    M_rgb = None
    rgb = None
    old_clr = old_wc = None
    if with_color:
        # reference: M_rgb = trafo_rgb_to_depth.calib_inv * M_d
        M_rgb = se3.matmul(se3.invert(rgb_to_depth), pose) if rgb_to_depth is not None else pose
        rgb = view.rgb
        old_rgb = vol.vox_rgb[ptr_c]
        old_clr = hv.clr_from_q(hv.rgb_clr_q(old_rgb))
        old_wc = hv.rgb_wc(old_rgb)

    new_sdf, new_w, new_clr, new_wc = tsdf.integrate_dense(
        old_sdf,
        old_w,
        pt_world,
        pose,
        proj,
        view.depth,
        sp.mu,
        sp.max_w,
        stop_at_max_w=sp.stop_integrating_at_max_w,
        vol_clr=old_clr,
        vol_wc=old_wc,
        M_rgb=M_rgb,
        proj_rgb=proj_rgb,
        rgb=rgb,
    )

    if enable is not True:
        keep = jnp.asarray(enable)
        new_sdf = jnp.where(keep, new_sdf, old_sdf)
        new_w = jnp.where(keep, new_w, old_w)
        if with_color:
            new_clr = jnp.where(keep, new_clr, old_clr)
            new_wc = jnp.where(keep, new_wc, old_wc)

    scatter_idx = jnp.where(valid, ptr_c, B)  # B → dropped
    vox = vol.vox.at[scatter_idx].set(
        hv.pack_vox(hv.sdf_to_q(new_sdf), new_w), mode="drop"
    )
    vox_rgb = vol.vox_rgb
    if with_color:
        vox_rgb = vol.vox_rgb.at[scatter_idx].set(
            hv.pack_rgb(hv.clr_to_q(new_clr), new_wc), mode="drop"
        )
    return vol._replace(vox=vox, vox_rgb=vox_rgb)


def _project_block_corners(
    bpos: jnp.ndarray,  # [V, 3] float32 block coords
    pose: jnp.ndarray,
    proj: jnp.ndarray,
    factor: float,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Project the 8 corners of each block → (U, V, Z) stacks [V, 8]
    (reference: ProjectSingleBlock, DeviceAgnostic/ITMVisualisationEngine.h:28).
    Corners behind the camera map to ∓1e9 so bboxes flood conservatively."""
    fx, fy, cx, cy = proj[0], proj[1], proj[2], proj[3]
    us, vs, zs = [], [], []
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                corner = (bpos + jnp.array([dx, dy, dz], dtype=jnp.float32)) * factor
                pc = se3.apply(pose, corner)
                z = pc[..., 2]
                ok = z > 1e-6
                zsafe = jnp.where(ok, z, 1.0)
                us.append(jnp.where(ok, fx * pc[..., 0] / zsafe + cx, jnp.where(z <= 0, -1e9, 1e9)))
                vs.append(jnp.where(ok, fy * pc[..., 1] / zsafe + cy, jnp.where(z <= 0, -1e9, 1e9)))
                zs.append(z)
    return jnp.stack(us, -1), jnp.stack(vs, -1), jnp.stack(zs, -1)


# expected_depth_ranges' raster tiles, in subsampled cells: every block's
# tile, and the tile of the compacted near-camera tier with its capacity.
# A 1 cm-voxel block (8 cm) at the 0.35 m near plane spans ≤ 26 cells at
# f = 525 px and the ×8 subsampling.
MINMAX_MAX_T = 8
MINMAX_BIG_T = 32
MINMAX_BIG_CAP = 256


def expected_depth_ranges(
    vol: HashVolume,
    render_state: RenderStateVH,
    pose: jnp.ndarray,
    proj: jnp.ndarray,
    img_size: Tuple[int, int],
    settings: Settings,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-pixel raycast search range from visible-block projections
    (reference: CreateExpectedDepths → projectAndSplitBlocks + fillBlocks —
    atomicMin/Max z into a ×8-subsampled minmax image → scatter-min/max here).

    Returns (zmin, zmax, n_too_big) — ranges at FULL resolution (upsampled
    from the subsampled grid like the reference's raycast lookup does) plus
    the count of visible blocks too large to rasterize.
    """
    hp = settings.hashing
    sp = settings.scene
    H, W = img_size
    sub = settings.minmax_subsample
    Hs, Ws = (H + sub - 1) // sub, (W + sub - 1) // sub

    ids = render_state.visible_ids
    # work ∝ visibility (the reference's grid=noVisibleEntries launch):
    # static cap, overflow blocks fall out of the minmax image this frame
    if settings.max_render_blocks and settings.max_render_blocks < ids.shape[0]:
        ids = ids[: settings.max_render_blocks]
    ids_c = jnp.clip(ids, 0, hp.n_entries - 1)
    ptr = vol.entry_ptr[ids_c]
    bpos = vol.entry_pos[ids_c].astype(jnp.float32)
    valid = (ids >= 0) & (ptr >= 0)

    U, V, Z = _project_block_corners(
        bpos, pose, proj, hp.block_size * sp.voxel_size
    )
    behind = jnp.any(Z <= 0, axis=-1)  # block partly behind camera: fall back
    u0 = jnp.clip(jnp.floor(jnp.min(U, axis=-1) / sub).astype(jnp.int32), 0, Ws - 1)
    u1 = jnp.clip(jnp.ceil(jnp.max(U, axis=-1) / sub).astype(jnp.int32), 0, Ws - 1)
    v0 = jnp.clip(jnp.floor(jnp.min(V, axis=-1) / sub).astype(jnp.int32), 0, Hs - 1)
    v1 = jnp.clip(jnp.ceil(jnp.max(V, axis=-1) / sub).astype(jnp.int32), 0, Hs - 1)
    zmin_b = jnp.maximum(jnp.min(Z, axis=-1), sp.view_frustum_min)
    zmax_b = jnp.minimum(jnp.max(Z, axis=-1), sp.view_frustum_max)
    zmin_b = jnp.where(behind, sp.view_frustum_min, zmin_b)
    zmax_b = jnp.where(behind, sp.view_frustum_max, zmax_b)

    # Rasterize bboxes into the subsampled minmax grid with scatter-min/max.
    # Every block gets a MAX_T×MAX_T tile (cells outside its bbox drop);
    # the few wider ones — near the camera — are compacted into a second
    # raster with BIG_T×BIG_T tiles. Blocks wider than BIG_T cells, or
    # beyond BIG_CAP, are left out and counted in n_too_big.
    span = jnp.maximum(u1 - u0, v1 - v0)
    small = valid & (span < MINMAX_MAX_T)
    big = valid & ~small
    bidx = jnp.nonzero(big & (span < MINMAX_BIG_T), size=MINMAX_BIG_CAP, fill_value=-1)[0]
    n_too_big = (jnp.sum(big) - jnp.sum(bidx >= 0)).astype(jnp.int32)
    zmin_img = jnp.full((Hs * Ws,), sp.view_frustum_max, dtype=jnp.float32)
    zmax_img = jnp.full((Hs * Ws,), sp.view_frustum_min, dtype=jnp.float32)
    for rows, ok, T in (
        (slice(None), small, MINMAX_MAX_T),
        (jnp.maximum(bidx, 0), bidx >= 0, MINMAX_BIG_T),
    ):
        dus = jnp.arange(T)
        uu = u0[rows][:, None, None] + dus[None, :, None]  # [N, T, 1]
        vv = v0[rows][:, None, None] + dus[None, None, :]  # [N, 1, T]
        in_box = (
            (uu <= u1[rows][:, None, None]) & (vv <= v1[rows][:, None, None])
            & ok[:, None, None]
        )
        flat = jnp.where(in_box, vv * Ws + uu, Hs * Ws).reshape(-1)  # → dropped
        zl = jnp.broadcast_to(zmin_b[rows][:, None, None], in_box.shape).reshape(-1)
        zh = jnp.broadcast_to(zmax_b[rows][:, None, None], in_box.shape).reshape(-1)
        zmin_img = zmin_img.at[flat].min(zl, mode="drop")
        zmax_img = zmax_img.at[flat].max(zh, mode="drop")

    zmin_img = zmin_img.reshape(Hs, Ws)
    zmax_img = zmax_img.reshape(Hs, Ws)
    # empty cells: zmax < zmin → collapse the march to a no-op
    empty = zmax_img < zmin_img
    zmin_img = jnp.where(empty, sp.view_frustum_max, zmin_img)
    zmax_img = jnp.where(empty, sp.view_frustum_max, zmax_img)

    # upsample to full res (nearest; reference raycast reads the subsampled
    # image directly at x/8). Exact-division images upsample as a dense
    # broadcast-reshape; the gather path is the ragged-edge fallback only.
    if H % sub == 0 and W % sub == 0:
        def up(img):
            return jnp.broadcast_to(
                img[:, None, :, None], (Hs, sub, Ws, sub)
            ).reshape(H, W)
        return up(zmin_img), up(zmax_img), n_too_big
    rows = jnp.arange(H) // sub
    cols = jnp.arange(W) // sub
    return zmin_img[rows][:, cols], zmax_img[rows][:, cols], n_too_big


def raycast_kernel_enabled(settings: Settings) -> bool:
    """The Triton raycast (ops/raycast_kernel.py) is the GPU path; elsewhere
    XLA runs the plain lock-step march of ops/raycast.py, its reference."""
    return settings.use_block_grid and jax.default_backend() == "gpu"


def raycast_hash(
    vol: HashVolume,
    render_state: RenderStateVH,
    pose: jnp.ndarray,
    proj: jnp.ndarray,
    img_size: Tuple[int, int],
    settings: Settings,
) -> rc.RaycastResult:
    """Full-image raycast over the visible blocks' expected-depth ranges
    (reference: CreateExpectedDepths + genericRaycast_device). The result
    carries the raster's count of visible blocks too large to rasterize
    (FrameDiagnostics.n_too_big_blocks)."""
    sp = settings.scene
    hp = settings.hashing
    zmin, zmax, n_too_big = expected_depth_ranges(
        vol, render_state, pose, proj, img_size, settings
    )
    rays = rc.pixel_rays(
        se3.invert(pose), proj, img_size, 1.0 / sp.voxel_size, zmin, zmax
    )
    step_scale = sp.mu / sp.voxel_size
    if not settings.use_block_grid:
        read = hv.make_hash_reader(vol, hp)
        points = rc.raycast_rays(read, *rays, step_scale, hp.block_size)
        return rc.RaycastResult(points=points, n_too_big_blocks=n_too_big)
    grid = hv.get_block_grid(vol, settings.block_grid, hp)
    if raycast_kernel_enabled(settings):
        from infinitam_tpu.ops import raycast_kernel as rk

        points = rk.raycast_grid(
            *rays, grid, vol.vox, step_scale,
            settings.block_grid.dims, settings.block_grid.origin, hp.block_size,
        )
    else:
        read = hv.make_grid_reader(vol, grid, settings.block_grid, hp)
        points = rc.raycast_rays(read, *rays, step_scale, hp.block_size)
    return rc.RaycastResult(points=points, n_too_big_blocks=n_too_big)


@partial(jax.jit, static_argnames=("settings", "img_size"))
def find_visible_blocks(
    vol: HashVolume,
    pose: jnp.ndarray,
    proj: jnp.ndarray,
    img_size: Tuple[int, int],
    settings: Settings,
) -> RenderStateVH:
    """Visible-entry list for an ARBITRARY camera (reference:
    IITMVisualisationEngine::FindVisibleBlocks, used by the freeview render
    path of ITMMainEngine::GetImage, ITMMainEngine.cpp:176-182): projection
    check over every resident entry → compacted list. Off the per-frame hot
    path (the live list comes from allocate_scene_from_depth); this scans
    all E entries, which is fine at render cadence.

    RENDER-ONLY: the returned state has no claim/epoch planes (None) — it
    must never be fed back into process_frame_hash as the live render state
    (the compact allocator would fall back to the legacy path and the claim
    continuity would break)."""
    hp = settings.hashing
    E = hp.n_entries
    resident = vol.entry_ptr >= 0
    vis = hv.check_block_visibility(
        vol.entry_pos, pose, proj, img_size,
        settings.scene.voxel_size, hp.block_size,
    )
    mask = resident & vis
    ids = jnp.nonzero(mask, size=hp.max_visible_blocks, fill_value=-1)[0].astype(
        jnp.int32
    )
    return RenderStateVH(
        visible_type=jnp.zeros((E,), jnp.int32),
        visible_ids=ids,
        n_visible=jnp.sum(mask).astype(jnp.int32),
    )


def prepare_tracking_maps(
    vol: HashVolume,
    render_state: RenderStateVH,
    pose: jnp.ndarray,
    proj: jnp.ndarray,
    img_size: Tuple[int, int],
    settings: Settings,
):
    """Returns (points_map, normals_map, n_too_big_blocks)."""
    res = raycast_hash(vol, render_state, pose, proj, img_size, settings)
    pm, nm = rc.make_icp_maps(res, settings.scene.voxel_size, se3.invert(pose))
    return pm, nm, res.n_too_big_blocks


def create_point_cloud(
    vol: HashVolume,
    render_state: RenderStateVH,
    pose: jnp.ndarray,  # world→depth-camera
    proj_rgb: jnp.ndarray,
    depth_to_rgb: jnp.ndarray,
    img_size: Tuple[int, int],
    settings: Settings,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Point cloud with colours for the photometric tracker, raycast in the
    RGB frame (reference: ITMTrackingController::Prepare color branch +
    ITMVisualisationEngine::CreatePointCloud). Returns (locations, colours)
    as [H, W, 4] maps with w-flag validity, and the raycast's
    n_too_big_blocks."""
    from infinitam_tpu.ops.voxel_access import read_color_interpolated

    pose_rgb = se3.matmul(depth_to_rgb, pose)
    res = raycast_hash(vol, render_state, pose_rgb, proj_rgb, img_size, settings)
    found = res.points[..., 3] > 0
    pts_m = res.points[..., :3] * settings.scene.voxel_size
    w = jnp.where(found, 1.0, -1.0)[..., None]
    locations = jnp.concatenate([jnp.where(found[..., None], pts_m, 0.0), w], axis=-1)
    read_color = hv.make_hash_color_reader(vol, settings.hashing)
    clr = read_color_interpolated(read_color, res.points[..., :3])
    colours = jnp.concatenate([jnp.where(found[..., None], clr, 0.0), w], axis=-1)
    return locations, colours, res.n_too_big_blocks


def _track_fuse_impl(
    vol: HashVolume,
    render_state: RenderStateVH,
    state: TrackingState,
    view: View,
    proj: jnp.ndarray,
    settings: Settings,
    fusion_active: bool,
    proj_rgb: jnp.ndarray | None,
    rgb_to_depth: jnp.ndarray | None,
    external_pose: jnp.ndarray | None,
    swap_states: jnp.ndarray | None = None,
):
    """Track → divergence gate → allocate (→ swapped-block realloc + swap
    marking) → integrate. The SINGLE tracker-dispatch/fusion orchestration
    shared by the plain frame step and the swapping frame step (reference:
    ITMDenseMapper::ProcessFrame runs identically whatever the tracker,
    ITMDenseMapper.cpp:51-65).

    Returns (vol, render_state, swap_states, pose, tr,
    n_alloc_overflow)."""
    from infinitam_tpu.config import TrackerType
    from infinitam_tpu.engine.trackers import track_color, track_external

    tt = settings.tracker_type

    with jax.named_scope("track"):
        if tt == TrackerType.EXTERNAL:
            tr = track_external(state.pose, external_pose if external_pose is not None else state.pose)
        elif tt == TrackerType.COLOR:
            pr = proj_rgb if proj_rgb is not None else proj
            r2d = rgb_to_depth if rgb_to_depth is not None else jnp.eye(4)
            tr = track_color(
                state.pose,
                view.rgb,
                pr,
                state.points_map,  # locations
                state.normals_map,  # colours (same buffer pair as the reference)
                se3.invert(r2d),
                r2d,
                settings.tracking,
                skip_points=settings.skip_points,
            )
        elif tt == TrackerType.REN:
            # composite ICP→Ren (reference: ITMTrackerFactory MakeRenTracker —
            # ICP runs the coarse levels (noICPRunTillLevel=1), the SDF tracker
            # refines at the finest level against the volume directly)
            import dataclasses as _dc

            from infinitam_tpu.engine.trackers import track_ren

            icp_params = _dc.replace(settings.tracking, no_icp_run_till_level=1)
            tr_icp = track_depth(
                state.pose,
                view.depth,
                proj,
                state.points_map,
                state.normals_map,
                state.pose_point_cloud,
                icp_params,
            )
            if settings.use_block_grid:
                _grid = hv.get_block_grid(vol, settings.block_grid, settings.hashing)
                _read = hv.make_grid_reader(vol, _grid, settings.block_grid, settings.hashing)
            else:
                _read = hv.make_hash_reader(vol, settings.hashing)
            tr = track_ren(
                tr_icp.pose, view.depth, proj, _read, settings.scene.voxel_size, settings.tracking
            )
            # report the Ren refinement's OWN energy (a diverging refinement must
            # be visible in metrics); num_valid keeps the ICP correspondence count
            # (Ren's point count is not a validity measure). The divergence gate
            # below uses the ICP pre-step's f, whose 1e5 sentinel scale it knows.
            gate_f = tr_icp.f
            tr = tr._replace(num_valid=tr_icp.num_valid)
        elif tt == TrackerType.WICP:
            tr = track_depth(
                state.pose,
                view.depth,
                proj,
                state.points_map,
                state.normals_map,
                state.pose_point_cloud,
                settings.tracking,
                weights_map=view.depth_uncertainty,
            )
        else:
            tr = track_depth(
                state.pose,
                view.depth,
                proj,
                state.points_map,
                state.normals_map,
                state.pose_point_cloud,
                settings.tracking,
            )
    have_maps = state.age >= 0
    # Divergence policy (SURVEY.md §5; the gate the reference computes but
    # never consumes — noValidPoints>100, ITMDepthTracker_CUDA.cu:105): a
    # frame whose tracking energy spiked keeps the LAST GOOD pose and is not
    # fused into the map.
    if tt != TrackerType.REN:
        gate_f = tr.f
    dvt = settings.tracking.divergence_f_threshold
    track_bad = (gate_f >= dvt) & have_maps if dvt > 0 else jnp.array(False)
    pose = jnp.where(have_maps & ~track_bad, tr.pose, state.pose)
    fuse_enable = ~track_bad

    with jax.named_scope("allocate"):
        vol, render_state, n_alloc_overflow = allocate_scene_from_depth(
            vol, render_state, view.depth, pose, proj, settings,
            only_update_visible=not fusion_active,
            enable=fuse_enable,
        )
        if swap_states is not None:
            from infinitam_tpu.engine import swapping as sw

            vol = sw.reallocate_swapped_out(
                vol, render_state.visible_type, settings,
                visible_ids=render_state.visible_ids,
            )
            swap_states = sw.mark_visible_for_swap_compact(
                swap_states, render_state.visible_ids
            )
    with jax.named_scope("integrate"):
        if fusion_active:
            vol = integrate_into_scene(
                vol, render_state, view, pose, proj, settings,
                proj_rgb=proj_rgb, rgb_to_depth=rgb_to_depth,
                enable=fuse_enable,
            )
    return vol, render_state, swap_states, pose, tr, n_alloc_overflow


def _prepare_impl(
    vol: HashVolume,
    render_state: RenderStateVH,
    state: TrackingState,
    view: View,
    pose: jnp.ndarray,
    tr: TrackResult,
    proj: jnp.ndarray,
    settings: Settings,
    proj_rgb: jnp.ndarray | None,
    rgb_to_depth: jnp.ndarray | None,
) -> Tuple[TrackingState, jnp.ndarray]:
    """Raycast-prepare the next frame's tracking maps (reference:
    ITMTrackingController::Prepare — color branch raycasts in the rgb frame,
    useApproximateRaycast keeps stale maps until TrackerFarFromPointCloud).
    Returns (state, n_too_big_blocks of the raycast)."""
    from infinitam_tpu.config import TrackerType

    img_size = view.depth.shape
    tt = settings.tracker_type

    with jax.named_scope("raycast"):
        if tt == TrackerType.COLOR:
            points_map, normals_map, n_too_big = create_point_cloud(
                vol,
                render_state,
                pose,
                proj_rgb if proj_rgb is not None else proj,
                se3.invert(rgb_to_depth) if rgb_to_depth is not None else jnp.eye(4),
                img_size,
                settings,
            )
            pose_pc = pose
            age = jnp.array(0, dtype=jnp.int32)
        elif settings.use_approximate_raycast:
            # reference: ITMTrackingController — full CreateICPMaps only when the
            # camera moved away from the last raycast (TrackerFarFromPointCloud);
            # otherwise keep the stale maps and age them (the ForwardRender path
            # only refreshes the display raycast incrementally).
            from infinitam_tpu.engine.trackers import track_far_from_point_cloud

            requires_full = (state.age < 0) | track_far_from_point_cloud(
                pose, state.pose_point_cloud, state.age
            )

            def full_branch(_):
                pm, nm, ntb = prepare_tracking_maps(
                    vol, render_state, pose, proj, img_size, settings
                )
                return pm, nm, pose, jnp.array(0, dtype=jnp.int32), ntb

            def approx_branch(_):
                return (
                    state.points_map,
                    state.normals_map,
                    state.pose_point_cloud,
                    state.age + 1,
                    jnp.int32(0),
                )

            points_map, normals_map, pose_pc, age, n_too_big = jax.lax.cond(
                requires_full, full_branch, approx_branch, None
            )
        else:
            points_map, normals_map, n_too_big = prepare_tracking_maps(
                vol, render_state, pose, proj, img_size, settings
            )
            pose_pc = pose
            age = jnp.array(0, dtype=jnp.int32)

    return TrackingState(
        pose=pose,
        points_map=points_map,
        normals_map=normals_map,
        pose_point_cloud=pose_pc,
        age=age,
        f=tr.f,
        num_valid=tr.num_valid,
    ), n_too_big


def _frame_diag(
    vol, render_state, tr, settings, n_alloc_overflow, n_too_big
) -> FrameDiagnostics:
    n_vis = render_state.n_visible
    n_render = (
        jnp.maximum(n_vis - settings.max_render_blocks, 0).astype(jnp.int32)
        if settings.max_render_blocks else jnp.int32(0)
    )
    return FrameDiagnostics(
        f=tr.f,
        num_valid=tr.num_valid,
        n_visible=n_vis,
        n_free_blocks=vol.last_free_block + 1,
        n_alloc_overflow=n_alloc_overflow,
        n_render_overflow=n_render,
        n_too_big_blocks=n_too_big,
    )


@partial(jax.jit, static_argnames=("settings", "fusion_active"))
def process_frame_hash(
    vol: HashVolume,
    render_state: RenderStateVH,
    state: TrackingState,
    view: View,
    proj: jnp.ndarray,
    settings: Settings,
    fusion_active: bool = True,
    proj_rgb: jnp.ndarray | None = None,
    rgb_to_depth: jnp.ndarray | None = None,
    external_pose: jnp.ndarray | None = None,
) -> Tuple[HashVolume, RenderStateVH, TrackingState, FrameDiagnostics]:
    """One full frame on the hash volume: track → allocate+fuse → raycast.

    Tracker selection follows settings.tracker_type (reference:
    ITMTrackerFactory): ICP (depth), WICP (noise-weighted), COLOR
    (photometric, maps raycast in the rgb frame), REN (SDF refinement),
    EXTERNAL (pose injected)."""
    vol, render_state, _sw, pose, tr, n_alloc_overflow = _track_fuse_impl(
        vol, render_state, state, view, proj, settings, fusion_active,
        proj_rgb, rgb_to_depth, external_pose, swap_states=None,
    )
    new_state, n_too_big = _prepare_impl(
        vol, render_state, state, view, pose, tr, proj, settings,
        proj_rgb, rgb_to_depth,
    )
    diag = _frame_diag(vol, render_state, tr, settings, n_alloc_overflow, n_too_big)
    return vol, render_state, new_state, diag


@partial(jax.jit, static_argnames=("settings", "fusion_active"))
def step_frame_swap(
    vol: HashVolume,
    render_state: RenderStateVH,
    state: TrackingState,
    swap_states: jnp.ndarray,
    view: View,
    proj: jnp.ndarray,
    settings: Settings,
    fusion_active: bool = True,
    proj_rgb: jnp.ndarray | None = None,
    rgb_to_depth: jnp.ndarray | None = None,
    external_pose: jnp.ndarray | None = None,
    merge_flips: jnp.ndarray | None = None,  # [Q+1] in-meta (ids, count)
    merge_slab: jnp.ndarray | None = None,  # [D(+D)+1, S³] int32 data slab
):
    """ONE device program for the swap-mode frame: resolution of
    the PREVIOUS exchange's needed list (state flips + optional data-slab
    merge — transfers sized to the actual stored data, which is usually
    none) → the shared track→allocate→fuse orchestration → needed-list
    build over the compact visible list → rotating-window eviction →
    raycast prepare. The host exchange pipelines around it
    (swapping.SwapExchange) — unlike the reference's synchronous per-frame
    exchange, the swap path dispatches exactly ONE program per frame like
    the non-swap path, and the steady-state exchange traffic is two ~1 KB
    metadata copies per frame.

    Returns (vol, render_state, new_tracking_state, swap_states, diag,
    in_meta [Q+1] (ids, n), (ev_meta [Q+1], ev_sdf, ev_w, ev_clr, ev_wc))
    — the eviction slabs stay device-side; the host copies them only after
    learning n (SwapExchange stage B)."""
    from infinitam_tpu.engine import swapping as sw

    E = settings.hashing.n_entries
    if merge_flips is not None:
        # listed entries with no stored data resolve straight to state 2
        # (merge_flips is an earlier frame's in_meta device buffer — the
        # host never re-uploads it; the count row slices off here)
        flips = merge_flips[:-1]
        swap_states = swap_states.at[
            jnp.where(flips >= 0, flips, E)
        ].set(2, mode="drop")
    if merge_slab is not None:
        vol, swap_states = sw.merge_data_slab(
            vol, swap_states, merge_slab, settings,
            with_color=settings.use_color and vol.vox_rgb is not None,
        )
    vol, render_state, swap_states, pose, tr, n_alloc_overflow = _track_fuse_impl(
        vol, render_state, state, view, proj, settings, fusion_active,
        proj_rgb, rgb_to_depth, external_pose, swap_states=swap_states,
    )
    q = sw.exchange_quantum(settings)
    in_ids, in_n, swap_states = sw.build_swap_in_list_visible(
        swap_states, render_state.visible_ids, q
    )
    vol, swap_states, ev_ids, ev_sdf, ev_w, ev_clr, ev_wc, ev_n = (
        sw.evict_blocks_window(
            vol, swap_states, render_state.visible_type, settings,
            sw.evict_quantum(settings),
            render_state.epoch if render_state.epoch is not None
            else jnp.int32(0),
        )
    )
    new_state, n_too_big = _prepare_impl(
        vol, render_state, state, view, pose, tr, proj, settings,
        proj_rgb, rgb_to_depth,
    )
    diag = _frame_diag(vol, render_state, tr, settings, n_alloc_overflow, n_too_big)
    in_meta = jnp.concatenate([in_ids, in_n[None]])
    ev_meta = jnp.concatenate([ev_ids, ev_n[None]])
    return (
        vol, render_state, new_state, swap_states, diag,
        in_meta,
        (ev_meta, ev_sdf, ev_w, ev_clr, ev_wc),
    )


@partial(jax.jit, static_argnames=("settings", "fusion_active"))
def process_sequence_hash(
    vol: HashVolume,
    render_state: RenderStateVH,
    state: TrackingState,
    depths: jnp.ndarray,  # [N, H, W] metric depth frames
    proj: jnp.ndarray,
    settings: Settings,
    fusion_active: bool = True,
    rgbs: jnp.ndarray | None = None,  # [N, H, W, 3] float 0..1 (color fusion)
    proj_rgb: jnp.ndarray | None = None,
    rgb_to_depth: jnp.ndarray | None = None,
):
    """Replay N depth (+ optional RGB) frames as ONE on-device program
    (lax.scan over the frame recursion). The per-frame math is identical to
    process_frame_hash — the sequential track→fuse→raycast dependency is
    preserved by the scan carry — but the host dispatches once per SEQUENCE
    instead of once per frame (a live-camera deployment feeds frames through
    a device-side ring buffer the same way, see io.sources.DeviceFrameFeed).

    With `rgbs` (and settings.use_color / a color tracker) the scan carries
    the full RGB path.

    Returns (vol, render_state, state, poses [N,4,4], diags [N,...])."""

    def step(carry, frame):
        v, rs, st = carry
        depth, rgb = frame if rgbs is not None else (frame, None)
        v, rs, st, diag = process_frame_hash(
            v, rs, st, View(depth=depth, rgb=rgb), proj, settings,
            fusion_active=fusion_active,
            proj_rgb=proj_rgb, rgb_to_depth=rgb_to_depth,
        )
        return (v, rs, st), (st.pose, diag)

    xs = depths if rgbs is None else (depths, rgbs)
    (vol, render_state, state), (poses, diags) = jax.lax.scan(
        step, (vol, render_state, state), xs
    )
    return vol, render_state, state, poses, diags


def create_engine_state(settings: Settings, img_size: Tuple[int, int]):
    vol = hv.create_hash(
        settings.hashing, with_color=settings.use_color, grid_params=settings.block_grid
    )
    rs = hv.create_render_state(settings.hashing, grid_params=settings.block_grid)
    return vol, rs, create_tracking_state(img_size)
