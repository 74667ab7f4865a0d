"""TLAS-routed multi-chunk closest hit, for scenes of many table chunks.

PyTorch counterpart of ``tracer/kernels/tlas.py``. The dense multi-chunk
path (``conecull.nearest_hit_hybrid_feats`` at C > 1) runs one compaction
per chunk in phase A and one leaf-walk CTA per (chunk, subpacket), most of
them empty. This path adds the top level of a two-level hierarchy:

  1. ROUTE (:func:`route_pairs`): per-subpacket interval bounds against
     per-chunk boxes give the (chunk, g-block) pairs that may interact,
     chunk-major, from one sort of the C*g routing matrix.
  2. PHASE A per pair (:func:`tlas_candidates`): the group test and leaf
     refine of ``cone_candidates``, restricted to the pair's chunk, so ids
     come out chunk-relative; pairs are processed in blocks of
     ``pair_block`` to bound memory.
  3. WALK (:func:`routed_call`): one closest-hit walk per routed pair,
     ``routed_cuda`` (hand-written CUDA, ``csrc/routed.cu``, the split
     leaf walk of ``leafcull_cuda``: the routed rows cut into items of
     ``ROUTED_ITEM_PRIMS`` prims on a persistent grid, merged per ray by a
     packed (-u, slot) key) on CUDA tensors and ``routed_plain`` on CPU
     tensors.
  4. MERGE: per g-block, the pair partials are min-merged by t, first
     minimum in ascending chunk order (the lowest slot wins ties).

Budgets (npairs, kc) are fixed; exceeding either sets the overflow flag.
Row widths, budgets and the flag equal the JAX package's; the TPU's
8-row and 128-column padding of the routing compaction is dropped where
it changes no output. One deliberate difference: the JAX group compaction
keeps K0 = 128 ids while a group-mode row lists up to kg (192 at the
default chunk size), so a subpacket that meets 129-192 groups of one
chunk gets a row padded with the sentinel group id, unflagged (58 such
rows at 10M spheres). The port keeps max(K0, kg) ids: those rows list
every group, and every other row is unchanged.

At 100M spheres (about 1,000 chunks) the JAX package needed four fixes.
Here: the tables are assembled on the host (``build_cull_tables``), as
JAX's fix does; phase A runs ``pair_block`` pairs at a time
(:func:`tlas_candidates`); the merge runs ``_MERGE_ROWS`` g-rows at a
time (JAX's ``row_block``). JAX's fourth fix, the routed kernel called
over ranges of ``KSPLIT`` pairs (``nearest_hit_tlas_split``), is not
carried: it keeps the scalar-prefetched pair tables within TPU SMEM and
each program within the TPU compiler's limits, while ``routed.cu`` reads
the pair tables from global memory and one launch takes every pair.
Every walk's slots stay below the ``_NOSLOT`` sentinel, 2^30
(``leafcull.check_slot_space``, checked before each walk).
"""

from __future__ import annotations

import torch
from torch import Tensor

from tracer_torch.kernels import _lib, tilewalk
from tracer_torch.kernels.conecull import (ConeTables, bounds_from_feats,
                                           compact_ascending_rows,
                                           _pad_cols, _round_up,
                                           _slab_hit_cols, _ROW_ALIGN)
from tracer_torch.kernels.leafcull import (FEAT, MISS_KEY, _BIG, _NOSLOT,
                                           check_slot_space,
                                           closest_rows_plain, item_leaves,
                                           walked_leaves)

# g-block rows merged at a time: bounds the gathered (rows, kc, SP*S)
# temporaries (the JAX _tlas_merge's row_block).
_MERGE_ROWS = 64
# Prims per item of the routed walk: the fastest of 128/256/512 on the 10M
# rows (chip_smoke.py sweeps them), where the render's leaf walks keep 128.
ROUTED_ITEM_PRIMS = 256


def route_pairs(o_lo, o_hi, d_lo, d_hi, tables: ConeTables, subpackets: int,
                npairs: int, kc: int):
    """Chunk-level routing. Bounds (P, 3) with P = g * subpackets.

    Returns (pair_c (npairs,) i32, pair_gb (npairs,) i32, pair_active
    (npairs,) bool, merge_pos (g, kc_eff) i32 routed-pair positions
    (npairs where unused), overflow 0-d bool). Pairs are sorted chunk-major
    (ascending c, then g-block); unused pairs are (C - 1, 0), inactive.
    """
    cull = tables.cull
    C = cull.num_chunks
    P = o_lo.shape[0]
    g = P // subpackets
    gpc = cull.leaves_per_chunk // cull.leaves_per_group
    dev = o_lo.device

    # Chunk boxes from the group boxes (groups lie chunk-contiguously).
    cmin = cull.group_min.reshape(C, gpc, 3).amin(1)
    cmax = cull.group_max.reshape(C, gpc, 3).amax(1)
    cids = torch.arange(C, dtype=torch.int32, device=dev)
    real_chunk = cids * cull.leaves_per_chunk < cull.num_real_leaves
    chit = _slab_hit_cols(o_lo, o_hi, d_lo, d_hi,
                          tuple(cmin[None, :, a] for a in range(3)),
                          tuple(cmax[None, :, a] for a in range(3)))
    chit = chit & real_chunk[None, :]
    gbhit = chit.reshape(g, subpackets, C).any(dim=1)      # (g, C)

    # The flat chunk-major pair list, from one sort of the C*g matrix.
    flat = gbhit.t().reshape(-1)
    key = torch.where(flat, torch.arange(C * g, dtype=torch.int32,
                                         device=dev), C * g)
    take = _pad_cols(torch.sort(key).values[:npairs], npairs, C * g)
    total = flat.sum(dtype=torch.int32)
    active = take < C * g
    pair_c = torch.where(active, take // g, C - 1)
    pair_gb = torch.where(active, take % g, 0)

    # Merge side: per g-block its routed chunks (ascending) and each one's
    # position in the pair list, through the compactor.
    ccnt = gbhit.sum(dim=0, dtype=torch.int32)             # (C,)
    base = torch.cumsum(ccnt, 0, dtype=torch.int32) - ccnt
    jrank = torch.cumsum(gbhit.to(torch.int32), 0, dtype=torch.int32) - 1
    Cpad = _round_up(C, _ROW_ALIGN)
    cids_m = _pad_cols(torch.where(gbhit, cids[None, :], C), Cpad, C)
    kck = min(_round_up(kc, _ROW_ALIGN), Cpad)
    cpref, ccount = compact_ascending_rows(cids_m, C, kck)
    kc_eff = min(kc, kck)
    cpref = cpref[:, :kc_eff]
    safe_c = torch.clamp(cpref, max=C - 1).long()
    pos = base[safe_c] + torch.gather(jrank, 1, safe_c)
    valid = (cpref < C) & (pos < npairs)
    merge_pos = torch.where(valid, pos, npairs).to(torch.int32)
    overflow = (total > npairs) | torch.any(ccount > kc_eff)
    return pair_c, pair_gb, active, merge_pos, overflow


def _pair_block_rows(packed, gmin, gmax, tables, pair_c, pair_gb,
                     pair_active, S, k0, gkeep, k, kg, rowlen):
    """Phase A rows of one block of pairs: ((np, S, rowlen) i32, ovf)."""
    cull = tables.cull
    lpg, lpc = cull.leaves_per_group, cull.leaves_per_chunk
    gpc = lpc // lpg
    dev = packed.device
    np_ = pair_c.shape[0]
    P2 = np_ * S
    pb = packed[pair_gb.long()].reshape(P2, 12)
    po_lo, po_hi, pd_lo, pd_hi = (pb[:, i:i + 3] for i in range(0, 12, 3))
    pc = pair_c.long()

    # Group test inside the pair's chunk, broadcast over its S subpackets.
    def cols(x):
        v = x[pc].reshape(np_, 1, gpc, 3).expand(np_, S, gpc, 3)
        v = v.reshape(P2, gpc, 3)
        return tuple(v[:, :, a] for a in range(3))

    ghit = _slab_hit_cols(po_lo, po_hi, pd_lo, pd_hi, cols(gmin), cols(gmax))
    grel = torch.arange(gpc, dtype=torch.int32, device=dev)
    real = (pc[:, None] * gpc + grel[None, :]) * lpg < cull.num_real_leaves
    real = real[:, None, :].expand(np_, S, gpc).reshape(P2, gpc)
    act = pair_active[:, None].expand(np_, S).reshape(P2)
    ghit = ghit & real & act[:, None]
    gm_ids = _pad_cols(torch.where(ghit, grel[None, :], gpc),
                       _round_up(gpc, _ROW_ALIGN), gpc)
    gprefix, gtotal = compact_ascending_rows(gm_ids, gpc, gkeep)
    gcand = _pad_cols(gprefix[:, :k0], k0, gpc)

    # Leaf refine: attr-major leaf-box rows by global group id.
    pc2 = pc[:, None].expand(np_, S).reshape(P2)
    safe_g = torch.clamp(gcand, max=gpc - 1).long() + pc2[:, None] * gpc
    rows_lb = tables.leaf_boxes[safe_g]                  # (P2, k0, lpg*6)
    att = [rows_lb[:, :, a * lpg:(a + 1) * lpg].reshape(P2, -1)
           for a in range(6)]
    member = (gcand[:, :, None] * lpg
              + torch.arange(lpg, dtype=torch.int32, device=dev)) \
        .reshape(P2, -1)                                 # chunk-relative
    valid = (member < lpc) \
        & (member + pc2[:, None] * lpc < cull.num_real_leaves)
    lhit = _slab_hit_cols(po_lo, po_hi, pd_lo, pd_hi, tuple(att[0:3]),
                          tuple(att[3:6])) & valid
    K_l = min(member.shape[1], 8 * _ROW_ALIGN)
    lprefix, ltotal = compact_ascending_rows(
        torch.where(lhit, member, lpc), lpc, K_l)

    j = torch.arange(k, dtype=torch.int32, device=dev)
    lcnt = torch.clamp(ltotal, max=K_l)[:, None]
    lvals = torch.where(j < torch.clamp(lcnt, max=k),
                        _pad_cols(lprefix[:, :k], k, lpc), lpc)
    jg = torch.arange(kg, dtype=torch.int32, device=dev)
    gcnt = gtotal[:, None]
    gvals = torch.where(jg < torch.clamp(gcnt, max=kg),
                        _pad_cols(gprefix[:, :kg], kg, gpc), gpc)

    use_g = (ltotal[:, None] > k) | (gtotal[:, None] > k0) \
        | (ltotal[:, None] > K_l)
    ovf = torch.any(use_g & (gtotal[:, None] > kg))
    width = max(k, kg)
    cnt_col = torch.where(use_g, -torch.clamp(gcnt, max=kg),
                          torch.clamp(lcnt, max=k))
    body = torch.where(use_g, _pad_cols(gvals, width, gpc),
                       _pad_cols(lvals, width, lpc))
    rows = _pad_cols(torch.cat([cnt_col, body], dim=1), rowlen, lpc)
    return rows.reshape(np_, S, rowlen), ovf


def tlas_candidates(feats: Tensor, tables: ConeTables, max_groups: int,
                    max_candidates: int, npairs: int, kc: int,
                    pair_block: int = 8192):
    """Routed phase A: feats (g, S, SP, FEAT) -> per-pair candidate rows.

    Returns (rows (npairs, S, rowlen) i32 chunk-relative count-embedded
    rows in ``cone_candidates``' format, pair_c, pair_gb, merge_pos,
    overflow). Pairs are processed ``pair_block`` at a time, which bounds
    the leaf-refine temporaries and changes no result. No host sync.
    """
    cull = tables.cull
    lpg, lpc = cull.leaves_per_group, cull.leaves_per_chunk
    gpc = lpc // lpg
    C = cull.num_chunks
    g, S, _, _ = feats.shape

    k0 = max(8, _round_up(min(max_groups, gpc), 8))
    while k0 * lpg > 1024:      # the JAX compactor's row-width ceiling
        k0 -= 8
    k = min(max_candidates, lpc)
    rowlen = _round_up(k + 17, _ROW_ALIGN)
    kg = min(gpc, rowlen - 9)
    K0 = min(_round_up(gpc, _ROW_ALIGN),
             max(_round_up(k0, _ROW_ALIGN), _ROW_ALIGN))
    gkeep = max(K0, kg)         # JAX keeps K0: see the module docstring

    o_lo, o_hi, d_lo, d_hi = bounds_from_feats(feats)
    pair_c, pair_gb, active, merge_pos, overflow = route_pairs(
        o_lo, o_hi, d_lo, d_hi, tables, S, npairs, kc)
    packed = torch.cat([o_lo, o_hi, d_lo, d_hi], dim=1).reshape(g, S * 12)
    gmin = cull.group_min.reshape(C, gpc, 3)
    gmax = cull.group_max.reshape(C, gpc, 3)

    blocks = []
    for i in range(0, npairs, pair_block):
        sl = slice(i, i + pair_block)
        rows, ovf = _pair_block_rows(packed, gmin, gmax, tables, pair_c[sl],
                                     pair_gb[sl], active[sl], S, k0, gkeep,
                                     k, kg, rowlen)
        blocks.append(rows)
        overflow = overflow | ovf
    return torch.cat(blocks), pair_c, pair_gb, merge_pos, overflow


# ---------------------------------------------------------------------------
# The routed walk
# ---------------------------------------------------------------------------

def _check_routed_args(pair_c, pair_gb, cand, feats, prims, leaf_size,
                       leaves_per_chunk):
    npairs, S, _ = cand.shape
    if tuple(pair_c.shape) != (npairs,) or tuple(pair_gb.shape) != (npairs,):
        raise ValueError(f"pair tables {tuple(pair_c.shape)}, "
                         f"{tuple(pair_gb.shape)} for {npairs} rows")
    if feats.dim() != 4 or feats.shape[1] != S or feats.shape[3] != FEAT:
        raise ValueError(f"feats {tuple(feats.shape)} and rows "
                         f"{tuple(cand.shape)} disagree")
    if prims.dim() != 3 or tuple(prims.shape[1:]) != (
            leaves_per_chunk * leaf_size, 4):
        raise ValueError(f"prims {tuple(prims.shape)} does not hold chunks "
                         f"of {leaves_per_chunk} leaves")
    check_slot_space(prims.shape[0], leaves_per_chunk, leaf_size)
    if feats.dtype != torch.float32 or prims.dtype != torch.float32 or any(
            x.dtype != torch.int32 for x in (pair_c, pair_gb, cand)):
        raise ValueError("feats/prims must be float32, rows and pairs int32")


def routed_plain(pair_c: Tensor, pair_gb: Tensor, cand: Tensor,
                 feats: Tensor, prims: Tensor, leaf_size: int,
                 leaves_per_chunk: int, leaves_per_group: int,
                 pair_elems: int = 1 << 24):
    """Plain PyTorch routed walk: the contract of ``routed_cuda``.

    pair_c, pair_gb (Np,) i32 (valid chunk and packet ids); cand
    (Np, S, rowlen) i32 rows relative to chunk pair_c[p]; feats
    (G, S, SP, FEAT); prims (C, lpc*leaf_size, 4). Returns (t, slot), each
    (Np, SP, S): pair p's closest hit for the rays of packet pair_gb[p]
    among chunk pair_c[p]'s walked prims, lowest global slot on ties;
    (3e38, 2^30) where nothing hits.
    """
    _check_routed_args(pair_c, pair_gb, cand, feats, prims, leaf_size,
                       leaves_per_chunk)
    npairs, S, rowlen = cand.shape
    G, _, SP, _ = feats.shape
    q = torch.arange(npairs * S, device=feats.device)
    p, s = q // S, q % S
    t, slot = closest_rows_plain(
        feats.reshape(G * S, SP, FEAT), pair_gb.long()[p] * S + s,
        pair_c.long()[p], cand.reshape(-1, rowlen), prims, leaf_size,
        leaves_per_group, pair_elems)
    return (t.reshape(npairs, S, SP).permute(0, 2, 1).contiguous(),
            slot.reshape(npairs, S, SP).permute(0, 2, 1).contiguous())


def routed_cuda(pair_c: Tensor, pair_gb: Tensor, cand: Tensor,
                feats: Tensor, prims: Tensor, leaf_size: int,
                leaves_per_chunk: int, leaves_per_group: int):
    """The routed walk as the hand-written CUDA kernel (``csrc/routed.cu``):
    the routed rows split into items of :func:`item_leaves` leaves
    (``ROUTED_ITEM_PRIMS`` prims) on a persistent grid, merged per ray by a
    packed (-u, slot) key.

    Same arguments and (Np, SP, S) outputs as :func:`routed_plain`. Raises
    for tensors that are not on one CUDA device. Reads no device value on
    the host. Adds one to ``routed_cuda.launches`` per launch.
    """
    _lib.require_cuda("routed_cuda", pair_c, pair_gb, cand, feats, prims)
    _check_routed_args(pair_c, pair_gb, cand, feats, prims, leaf_size,
                       leaves_per_chunk)
    return _routed_launch(pair_c, pair_gb, cand, feats, prims, leaf_size,
                          leaves_per_chunk, leaves_per_group,
                          item_leaves(leaf_size, ROUTED_ITEM_PRIMS))


def _routed_launch(pair_c: Tensor, pair_gb: Tensor, cand: Tensor,
                   feats: Tensor, prims: Tensor, leaf_size: int,
                   leaves_per_chunk: int, leaves_per_group: int, chunk: int):
    """:func:`routed_cuda` with items of ``chunk`` walked leaves."""
    dev = feats.device
    npairs, S, rowlen = cand.shape
    SP = feats.shape[2]
    if not 1 <= SP <= 1024:
        raise ValueError(f"subpacket {SP} is not a valid CTA size")
    pair_c, pair_gb, cand, feats, prims = (
        x.contiguous() for x in (pair_c, pair_gb, cand, feats, prims))
    starts = tilewalk.plan_items(walked_leaves(cand, leaves_per_group), chunk)
    keys = torch.full((npairs, S, SP), MISS_KEY, dtype=torch.int64,
                      device=dev)
    t = torch.empty((npairs, SP, S), dtype=torch.float32, device=dev)
    slot = torch.empty((npairs, SP, S), dtype=torch.int32, device=dev)
    lib = _lib.load()
    with torch.cuda.device(dev):
        rc = lib.tracer_routed(
            _lib.ptr(pair_c), _lib.ptr(pair_gb), _lib.ptr(feats),
            _lib.ptr(cand), _lib.ptr(prims), _lib.ptr(starts), _lib.ptr(keys),
            _lib.ptr(t), _lib.ptr(slot), npairs, S, SP, rowlen, leaf_size,
            leaves_per_chunk, leaves_per_group, chunk, _lib.stream(dev))
    _lib.check(lib, rc, "routed_cuda")
    routed_cuda.launches += 1
    return t, slot


routed_cuda.launches = 0


def routed_call(pair_c: Tensor, pair_gb: Tensor, cand: Tensor,
                feats: Tensor, prims: Tensor, leaf_size: int,
                leaves_per_chunk: int, leaves_per_group: int):
    """Closest hit per routed pair, (t, slot) each (Np, SP, S). CPU tensors
    run :func:`routed_plain`; anything else goes to :func:`routed_cuda`,
    which launches the kernel or raises."""
    walk = routed_plain if feats.device.type == "cpu" else routed_cuda
    return walk(pair_c, pair_gb, cand, feats, prims, leaf_size,
                leaves_per_chunk, leaves_per_group)


def tlas_merge(t_p: Tensor, slot_p: Tensor, merge_pos: Tensor):
    """Per-g-block min-merge of routed partials (Np, SP, S) at merge_pos
    (g, kc): the first minimal t in ascending chunk order, _MERGE_ROWS
    g-rows at a time. Returns raw order (t (g*SP*S,), +inf on miss; slot,
    -1 on miss)."""
    npairs, SP, S = t_p.shape
    g = merge_pos.shape[0]
    t_flat = torch.cat([t_p.reshape(npairs, SP * S),
                        t_p.new_full((1, SP * S), _BIG)])
    s_flat = torch.cat([slot_p.reshape(npairs, SP * S),
                        slot_p.new_full((1, SP * S), _NOSLOT)])
    ts, ss = [], []
    for i in range(0, g, _MERGE_ROWS):
        mp = merge_pos[i:i + _MERGE_ROWS].long()
        tm, sm = t_flat[mp], s_flat[mp]                  # (rb, kc, SP*S)
        tm = torch.where(sm < _NOSLOT, tm, _BIG)
        ci = torch.argmin(tm, dim=1, keepdim=True)       # first minimum
        ts.append(torch.gather(tm, 1, ci)[:, 0])
        ss.append(torch.gather(sm, 1, ci)[:, 0])
    t, slot = torch.cat(ts).reshape(-1), torch.cat(ss).reshape(-1)
    hit = slot < _NOSLOT
    return (torch.where(hit, t, float("inf")),
            torch.where(hit, slot, -1))


def nearest_hit_tlas_feats(feats: Tensor, tables: ConeTables,
                           max_groups: int = 64, max_candidates: int = 119,
                           npairs: int = 8192, kc: int = 32,
                           pair_block: int = 8192):
    """Closest hit through the TLAS-routed pipeline, in raw order.

    Same (t, slot, overflow) contract as
    ``conecull.nearest_hit_hybrid_feats`` (index with ``kernel_order_dest``
    for ray order, map slots with ``tables.cull.slot_to_sphere``). Works at
    any chunk count; built for many chunks.
    """
    cull = tables.cull
    g = feats.shape[0]
    npairs = min(npairs, cull.num_chunks * g)
    kc = min(kc, cull.num_chunks)
    rows, pair_c, pair_gb, merge_pos, overflow = tlas_candidates(
        feats, tables, max_groups, max_candidates, npairs, kc, pair_block)
    t_p, slot_p = routed_call(pair_c, pair_gb, rows, feats, cull.prims,
                              cull.leaf_size, cull.leaves_per_chunk,
                              cull.leaves_per_group)
    t, slot = tlas_merge(t_p, slot_p, merge_pos)
    return t, slot, overflow
