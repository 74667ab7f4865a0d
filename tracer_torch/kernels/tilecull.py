"""Tile cull: 128-ray subpackets against their candidate 128-prim tiles
(``--impl tilecull``).

PyTorch counterpart of ``tracer/kernels/tilecull.py``. Phase A
(:func:`subpacket_candidates`) slab-tests each subpacket's interval bounds
against every leaf box (``intersect/cull.py``), marks the 128-slot tiles
holding a surviving leaf, and compacts their ids into a count-embedded row
``[count, tile ids ascending..., T padding]`` with the row compactor
(``conecull.compact_ascending_rows``); the walk then tests every ray of the
subpacket against every prim of its listed tiles and keeps the nearest hit:
min t, lowest slot on ties; a miss is (3e38, 2^30).

The walk is a hand-written CUDA kernel on CUDA tensors (``tilecull_cuda``,
``csrc/tilecull.cu``) and a plain PyTorch version with the same contract on
CPU tensors (``tilecull_plain``); :func:`tilecull_call` picks by device and
raises for any other. Both round exactly alike (the test of the leaf
walks on oc = o - c, ``leafcull.ray_prim_u``), so they agree bit for bit.

Per-ray features are the leaf walk's 16-column rows (``leafcull.
pack_ray_features``): d, o, a and 1/max(a, 1e-30) are the columns it
reads.
"""

from __future__ import annotations

import torch
from torch import Tensor

from tracer_torch import trace
from tracer_torch.core.types import Ray
from tracer_torch.intersect.brute import record_from_ids
from tracer_torch.intersect.cull import LANES, LeafTable, tile_candidates
from tracer_torch.intersect.sphere import EPSILON
from tracer_torch.kernels import _lib, tilewalk
from tracer_torch.kernels.cull import cull_tiles
from tracer_torch.kernels.leafcull import (FEAT, _BIG, _NOSLOT, _escalate,
                                           _pad_edge,
                                           pack_ray_features as _pack_feats,
                                           ray_prim_u)
from tracer_torch.kernels.traverse import PackedBVH
from tracer_torch.scene.scene import Scene

SUBPACKET = 128          # rays per frustum / candidate row (one CTA)
MISS_KEY = tilewalk.miss_key(_BIG, _NOSLOT)   # (3e38, 2^30)


def pack_prim_tiles(packed: PackedBVH) -> Tensor:
    """(T+1, 128, 4) f32 prim tiles (cx, cy, cz, r^2) in slot order: the
    packed prims (center, r^2), as the packet cull's
    (``cull.cull_tiles``). T = ceil(prim slots / 128), the leaf table's
    tile count. Slots past the packed prims (the last tile's tail) and the
    trailing tile T hold the sentinel (0, 0, 0, -1e30): its discriminant
    is (o.d)^2 - a(|o|^2 + 1e30) < 0, so it never hits. (The JAX table
    leaves that tail at zero, a radius-0 sphere at the origin.)"""
    return cull_tiles(packed)


def pack_ray_features(o: Tensor, d: Tensor, subpackets: int):
    """(B, 3) rays in order -> ((G, S, 128, FEAT) features, G, pad); padding
    rays replicate the last real ray."""
    return _pack_feats(o, d, subpackets, SUBPACKET)


@torch.no_grad()
def subpacket_candidates(o: Tensor, d: Tensor, table: LeafTable,
                         max_candidates: int, subpackets: int):
    """Phase A at 128-ray granularity, count-embedded for the walk.

    o/d: the padded (G*S*128, 3) rays. Returns (cand (G, S, Kp) i32 with
    [g, s, 0] = min(count, K) and the surviving tile ids ascending from
    column 1, every unused column T; overflow: 0-d bool, some subpacket had
    more than K = max_candidates surviving tiles). Kp = K + 1 rounded up to
    a multiple of 128.
    """
    T = table.num_tiles
    K = max_candidates
    prefix, counts, overflow = tile_candidates(o, d, table, K, SUBPACKET)
    P = prefix.shape[0]
    kp = -(-(K + 1) // LANES) * LANES
    row = torch.full((P, kp), T, dtype=torch.int32, device=o.device)
    row[:, 0] = torch.clamp(counts[:, 0], max=K)
    row[:, 1:1 + prefix.shape[1]] = prefix
    return row.reshape(-1, subpackets, kp), overflow


def _check_args(feats: Tensor, cand: Tensor, prims: Tensor) -> None:
    G, S, SP, F = feats.shape
    if SP != SUBPACKET or F != FEAT or tuple(cand.shape[:2]) != (G, S):
        raise ValueError(f"feats {tuple(feats.shape)} and rows "
                         f"{tuple(cand.shape)} disagree")
    if prims.dim() != 3 or tuple(prims.shape[1:]) != (LANES, 4):
        raise ValueError(f"prims must be (T+1, {LANES}, 4), got "
                         f"{tuple(prims.shape)}")
    if feats.dtype != torch.float32 or prims.dtype != torch.float32 \
            or cand.dtype != torch.int32:
        raise ValueError("feats/prims must be float32 and rows int32")


@torch.no_grad()
def tilecull_plain(feats: Tensor, cand: Tensor, prims: Tensor,
                   pair_elems: int = 1 << 24):
    """Plain PyTorch tile walk: the contract of ``tilecull_cuda``.

    feats (G, S, 128, FEAT) f32; cand (G, S, Kp) i32 count-embedded tile
    rows; prims (T+1, 128, 4). Returns (t, slot), each (G, 128, S), ray
    g*S*128 + s*128 + r at [g, r, s]: the smallest t = (-u) * (1/a) with
    disc > 0 and EPSILON < t < 3e38 over the listed tiles' prims, lowest
    slot among equal t; (3e38, 2^30) where nothing hits. Every (subpacket,
    tile) pair is enumerated (a host sync sizes the list) and tested in
    slices of at most ``pair_elems`` (pair, ray, prim) elements.
    """
    _check_args(feats, cand, prims)
    G, S, SP, _ = feats.shape
    P = G * S
    dev = feats.device
    f = feats.reshape(P, SP, FEAT)
    rows = cand.reshape(P, -1).long()
    counts = rows[:, 0]
    q_all = torch.repeat_interleave(torch.arange(P, device=dev), counts)
    k_all = torch.arange(q_all.shape[0], device=dev) \
        - (torch.cumsum(counts, 0) - counts)[q_all]
    tile_all = rows[q_all, 1 + k_all]
    best_t = torch.full((P, SP), _BIG, dtype=torch.float32, device=dev)
    best_slot = torch.full((P, SP), _NOSLOT, dtype=torch.int64, device=dev)
    step = max(1, pair_elems // (SP * LANES))
    for i in range(0, q_all.shape[0], step):
        q, tile = q_all[i:i + step], tile_all[i:i + step]
        fb = f[q]                                          # (n, SP, FEAT)
        u, disc = ray_prim_u(fb, prims[tile])              # (n, SP, 128)
        t = (-u) * fb[:, :, 11:12]
        ok = (disc > 0.0) & (t > EPSILON) & (t < _BIG)
        tv = torch.where(ok, t, torch.full_like(t, _BIG))
        pt, arg = torch.min(tv, dim=2)               # first min: lowest slot
        pslot = torch.where(pt < _BIG, tile[:, None] * LANES + arg,
                            torch.full_like(arg, _NOSLOT))
        qi = q[:, None].expand(-1, SP)
        before = best_t.clone()
        best_t.scatter_reduce_(0, qi, pt, "amin")
        best_slot.masked_fill_(best_t < before, _NOSLOT)   # a smaller t came
        cand_slot = torch.where(pt == best_t[q], pslot,
                                torch.full_like(pslot, _NOSLOT))
        best_slot.scatter_reduce_(0, qi, cand_slot, "amin")
    t = best_t.reshape(G, S, SP).permute(0, 2, 1).contiguous()
    slot = best_slot.to(torch.int32).reshape(G, S, SP).permute(0, 2, 1)
    return t, slot.contiguous()


def tilecull_cuda(feats: Tensor, cand: Tensor, prims: Tensor):
    """The tile walk as the hand-written CUDA kernel (``csrc/tilecull.cu``):
    rows split into items of ``tilewalk.CHUNK`` listed tiles on a persistent
    grid of 128-thread CTAs, merged per ray by a packed (t, slot) key.

    Same arguments and (t, slot) outputs as :func:`tilecull_plain`. Raises
    for tensors that are not on one CUDA device. Reads no device value on
    the host.
    """
    dev = _lib.require_cuda("tilecull_cuda", feats, cand, prims)
    _check_args(feats, cand, prims)
    G, S, SP, _ = feats.shape
    P, kp = G * S, cand.shape[-1]
    chunk = tilewalk.CHUNK
    feats, cand, prims = (x.contiguous() for x in (feats, cand, prims))
    starts = tilewalk.plan_items(walked_tiles(cand), chunk)
    keys = torch.full((P * SP,), MISS_KEY, dtype=torch.int64, device=dev)
    _lib.launch("tilecull_cuda", "tracer_tilecull", dev, feats, cand, prims,
                starts, keys, P, kp, chunk)
    return results_from_keys(keys, G, S)


def walked_tiles(cand: Tensor) -> Tensor:
    """(G * S,) listed tiles each row of ``cand`` walks: its count column
    clamped to [0, Kp - 1]."""
    kp = cand.shape[-1]
    return cand.reshape(-1, kp)[:, 0].clamp(0, kp - 1)


def results_from_keys(keys: Tensor, G: int, S: int):
    """Merged keys (G * S * 128,) in ray order -> (t, slot), each
    (G, 128, S) as :func:`tilecull_plain` lays them out; a miss key is
    (3e38, 2^30)."""
    t, slot = tilewalk.unpack_keys(keys.reshape(G, S, SUBPACKET)
                                   .permute(0, 2, 1))
    return t.contiguous(), slot.to(torch.int32).contiguous()


@trace.spanned("walk")
def tilecull_call(feats: Tensor, cand: Tensor, prims: Tensor):
    """Nearest hit per ray over its subpacket's candidate tiles: (t, slot),
    each (G, 128, S). CPU tensors run :func:`tilecull_plain`; anything else
    goes to :func:`tilecull_cuda`, which launches the kernel or raises."""
    if feats.device.type == "cpu":
        return tilecull_plain(feats, cand, prims)
    return tilecull_cuda(feats, cand, prims)


def nearest_hit_tilecull(rays: Ray, scene: Scene, packed: PackedBVH,
                         table: LeafTable, max_candidates: int = 64,
                         subpackets: int = 8):
    """Closest hit via the 128-ray tile cull; batch shape preserved.

    Returns ``(HitRecord, overflow)``: on overflow some subpacket lost
    tiles past the budget, and its hits may be missing; re-dispatch with a
    larger budget (:func:`nearest_hit_tilecull_checked` does). t is
    recomputed from the winning sphere with the reference formulation, so
    autograd reaches the scene.
    """
    batch_shape = rays.batch_shape
    o = rays.origin.reshape(-1, 3)
    d = rays.direction.reshape(-1, 3)
    b = o.shape[0]
    with torch.no_grad():
        od, dd = o.detach(), d.detach()
        feats, g, pad = pack_ray_features(od, dd, subpackets)
        cand, overflow = subpacket_candidates(
            _pad_edge(od, pad), _pad_edge(dd, pad), table, max_candidates,
            subpackets)
        _, slot = tilecull_call(feats, cand, pack_prim_tiles(packed))
        slot = slot.permute(0, 2, 1).reshape(-1)[:b]
        hit = slot < _NOSLOT
        idx = torch.where(hit, packed.prim_idx[torch.where(
            hit, slot, 0).long()], torch.full_like(slot, -1))
    rec = record_from_ids(o, d, idx, scene).reshape(batch_shape)
    return rec, overflow


@trace.spanned("nearest")
def nearest_hit_tilecull_checked(rays: Ray, scene: Scene, packed: PackedBVH,
                                 table: LeafTable, max_candidates: int = 64,
                                 subpackets: int = 8):
    """Escalating driver: doubles the candidate budget until no subpacket
    overflows, as the JAX driver does. Returns (HitRecord, escalations):
    how many times the budget was doubled (one host sync per try)."""
    n = rays.origin.numel() // 3
    trace.count_outermost(rays=n)
    T = table.num_tiles

    def grow(budgets):
        (k,) = budgets
        return None if k >= T else (min(2 * k, -(-T // LANES) * LANES),)
    return _escalate(lambda k: nearest_hit_tilecull(
        rays, scene, packed, table, max_candidates=k, subpackets=subpackets),
        n, (max_candidates,), grow)
