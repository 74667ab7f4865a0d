"""Packet cull: 1024-ray packets against their candidate 128-prim tiles.

PyTorch counterpart of ``tracer/kernels/cull_pallas.py``. Phase A
(``intersect.cull.tile_candidates``) slab-tests each 1024-ray packet's
interval bounds against every leaf box and lists the 128-slot tiles that
hold a surviving leaf, ascending, with the raw count; the walk tests every
ray of the packet against every prim of its listed tiles, in ascending tile
order and then ascending lane, and keeps the nearest hit with a strict
``t < best``, so the first of equal t wins.

The walk is a hand-written CUDA kernel on CUDA tensors (``cull_cuda``,
``csrc/cull.cu``) and a plain PyTorch version with the same contract on CPU
tensors (``cull_plain``); :func:`cull_call` picks by device and raises for
any other. Both spell the JAX kernel's b-form in the same f32 operations
(hb = oc.d, cq = |oc|^2 - r^2, disc4 = hb^2 - a*cq,
t = (-hb - sqrt(disc4)) / a; no FMA contraction, correctly rounded sqrt),
so they agree bit for bit.

The walk runs to min(count, K) tiles per packet. The JAX kernel runs to the
raw count, which exceeds K on overflow, and then reads past the packet's K
candidates (interpret mode clamps the index, which hides it); the port does
not copy that.
"""

from __future__ import annotations

import torch
from torch import Tensor

from tracer_torch import trace
from tracer_torch.core.types import Ray
from tracer_torch.intersect.brute import record_from_ids
from tracer_torch.intersect.cull import (LANES, LeafTable, prim_tiles,
                                         tile_candidates)
from tracer_torch.intersect.sphere import EPSILON
from tracer_torch.kernels import _lib, tilewalk
from tracer_torch.kernels.leafcull import _escalate, _pad_edge, _sqrt_rn
from tracer_torch.kernels.traverse import (PACKET, RAY_COLS, PackedBVH,
                                           pack_rays)
from tracer_torch.scene.scene import Scene

# (0, 0, 0, r^2 = -1e30): cq = |o|^2 + 1e30, so disc4 = (o.d)^2 - a*cq < 0
# for every ray; no ray can hit it.
_SENTINEL_RSQ = -1.0e30
MISS_KEY = tilewalk.miss_key(float("inf"), 0xFFFFFFFF)   # (+inf, -1)
BLOCKS = PACKET // LANES      # 128-ray blocks per packet, rows of the walk


def cull_tiles(packed: PackedBVH, num_tiles: int | None = None) -> Tensor:
    """The walk's (T+1, 128, 4) f32 prim tiles (centre, r^2) in slot order
    from the packed prims: slots past the packed prims, up to ``num_tiles``
    tiles (by default the fewest that hold them), and the trailing tile T
    (the id that pads candidate lists) hold the sentinel (0, 0, 0, -1e30),
    which no ray hits."""
    p = packed.prims
    return prim_tiles(p, p[:, 3], _SENTINEL_RSQ, num_tiles)


def _check_args(rays: Tensor, tiles: Tensor, cand: Tensor,
                counts: Tensor) -> None:
    g = rays.shape[0]
    if rays.dim() != 3 or tuple(rays.shape[1:]) != (PACKET, RAY_COLS) \
            or rays.dtype != torch.float32:
        raise ValueError(f"rays must be (g, {PACKET}, {RAY_COLS}) float32, "
                         f"got {tuple(rays.shape)} {rays.dtype}")
    if tiles.dim() != 3 or tuple(tiles.shape[1:]) != (LANES, 4) \
            or tiles.dtype != torch.float32:
        raise ValueError(f"tiles must be (T+1, {LANES}, 4) float32, got "
                         f"{tuple(tiles.shape)} {tiles.dtype}")
    if cand.dim() != 2 or cand.shape[0] != g or counts.numel() != g \
            or cand.dtype != torch.int32 or counts.dtype != torch.int32:
        raise ValueError(f"cand (g, K) and counts (g, 1) must be int32 for "
                         f"{g} packets, got {tuple(cand.shape)} "
                         f"{tuple(counts.shape)}")


def _cull_t(ox, oy, oz, dx, dy, dz, a, inv_a, cx, cy, cz, rsq):
    """t of the near root where disc4 > 0 and t > EPSILON, else +inf; the
    kernel's b-form, op for op."""
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    hb = ocx * dx + ocy * dy + ocz * dz
    cq = ocx * ocx + ocy * ocy + ocz * ocz - rsq
    disc4 = hb * hb - a * cq
    t = (-hb - _sqrt_rn(torch.clamp(disc4, min=0.0))) * inv_a
    ok = (disc4 > 0.0) & (t > EPSILON)
    return torch.where(ok, t, torch.full_like(t, float("inf")))


@torch.no_grad()
def cull_plain(rays: Tensor, tiles: Tensor, cand: Tensor, counts: Tensor,
               pair_elems: int = 1 << 24):
    """Plain PyTorch packet cull: the contract of ``cull_cuda``.

    rays (g, 1024, 8) f32 from ``traverse.pack_rays``; tiles (T+1, 128, 4)
    f32 from :func:`cull_tiles`; cand (g, K) i32 tile ids; counts (g, 1)
    i32, walked to min(count, K). Returns (t (g, 1024) f32, +inf on miss;
    slot (g, 1024) i32, tile * 128 + lane, -1 on miss): the smallest t,
    first in (listed position, lane) order among equal t. Every (packet,
    tile) pair is enumerated (a host sync sizes the list) and tested in
    slices of at most ``pair_elems`` (pair, ray, prim) elements.
    """
    _check_args(rays, tiles, cand, counts)
    g, K = cand.shape
    dev = rays.device
    n_k = torch.clamp(counts.reshape(-1).long(), 0, K)
    p_all = torch.repeat_interleave(torch.arange(g, device=dev), n_k)
    k_all = torch.arange(p_all.shape[0], device=dev) \
        - (torch.cumsum(n_k, 0) - n_k)[p_all]
    tile_all = cand[p_all, k_all].long()
    o = [rays[..., k, None] for k in range(3)]
    d = [rays[..., 3 + k, None] for k in range(3)]
    a = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    inv_a = 1.0 / torch.clamp(a, min=1e-30)
    terms = (*o, *d, a, inv_a)                           # each (g, 1024, 1)
    best_t = torch.full((g, PACKET), float("inf"), device=dev)
    no_key = p_all.shape[0] * LANES
    best_key = torch.full((g, PACKET), no_key, dtype=torch.int64, device=dev)
    step = max(1, pair_elems // (PACKET * LANES))
    for i in range(0, p_all.shape[0], step):
        p = p_all[i:i + step]
        q = tiles[tile_all[i:i + step]]                  # (n, 128, 4)
        t = _cull_t(*(x[p] for x in terms),
                    *(q[:, None, :, k] for k in range(4)))
        pt, arg = torch.min(t, dim=2)                    # first min: low lane
        key = (torch.arange(i, i + p.shape[0], device=dev)[:, None] * LANES
               + arg)                                    # (pair, lane) order
        pi = p[:, None].expand(-1, PACKET)
        before = best_t.clone()
        best_t.scatter_reduce_(0, pi, pt, "amin")
        best_key.masked_fill_(best_t < before, no_key)   # a smaller t came
        best_key.scatter_reduce_(0, pi, torch.where(
            pt == best_t[p], key, torch.full_like(key, no_key)), "amin")
    hit = torch.isfinite(best_t)
    if not no_key:
        return best_t, torch.full_like(best_key, -1, dtype=torch.int32)
    k = torch.clamp(best_key, max=no_key - 1)
    slot = tile_all[k // LANES] * LANES + k % LANES
    return best_t, torch.where(hit, slot, -1).to(torch.int32)


def cull_cuda(rays: Tensor, tiles: Tensor, cand: Tensor, counts: Tensor):
    """The packet cull as the hand-written CUDA kernel (``csrc/cull.cu``):
    each packet's eight 128-ray blocks share its row, the rows are split
    into items of ``tilewalk.CHUNK`` listed tiles on a persistent grid of
    128-thread CTAs, and each ray's hit is merged by a packed (t, listed
    position) key.

    Same arguments and (t, slot) outputs as :func:`cull_plain`. Raises for
    tensors that are not on one CUDA device. Reads no device value on the
    host.
    """
    dev = _lib.require_cuda("cull_cuda", rays, tiles, cand, counts)
    _check_args(rays, tiles, cand, counts)
    g, K = cand.shape
    chunk = tilewalk.CHUNK
    rays, tiles, cand, counts = (x.contiguous()
                                 for x in (rays, tiles, cand, counts))
    starts = tilewalk.plan_items(walked_tiles(counts, K), chunk)
    keys = torch.full((g * PACKET,), MISS_KEY, dtype=torch.int64, device=dev)
    _lib.launch("cull_cuda", "tracer_cull", dev, rays, tiles, cand, counts,
                starts, keys, g, K, chunk)
    return slots_from_keys(keys.reshape(g, PACKET), cand)


def walked_tiles(counts: Tensor, K: int) -> Tensor:
    """(g * 8,) listed tiles each 128-ray block walks: its packet's count
    clamped to [0, K]."""
    g = counts.numel()
    return counts.reshape(g, 1).clamp(0, K).expand(g, BLOCKS).reshape(-1)


def slots_from_keys(keys: Tensor, cand: Tensor):
    """(g, 1024) merged keys (t, k * 128 + lane) -> (t, slot): the listed
    position k mapped back to its tile through ``cand`` (g, K); a miss is
    (+inf, -1)."""
    t, idx = tilewalk.unpack_keys(keys)
    hit = keys != MISS_KEY
    if cand.shape[1] == 0:
        return t, torch.full_like(idx, -1, dtype=torch.int32)
    k = torch.where(hit, idx // LANES, 0)
    slot = cand.gather(1, k).to(torch.int64) * LANES + idx % LANES
    return t, torch.where(hit, slot, -1).to(torch.int32)


@trace.spanned("walk")
def cull_call(rays: Tensor, tiles: Tensor, cand: Tensor, counts: Tensor):
    """(t, slot) of the packet cull. CPU tensors run :func:`cull_plain`;
    anything else goes to :func:`cull_cuda`, which launches the kernel or
    raises."""
    if rays.device.type == "cpu":
        return cull_plain(rays, tiles, cand, counts)
    return cull_cuda(rays, tiles, cand, counts)


def nearest_hit_cull(rays: Ray, scene: Scene, packed: PackedBVH,
                     table: LeafTable, max_candidates: int = 128):
    """Closest hit via the packet cull; batch shape preserved.

    Rays should be sorted for coherence (``core.sort``). Returns
    ``(HitRecord, overflow)``: on overflow some packet had more surviving
    tiles than the budget and its hits may be missing; re-dispatch with a
    larger budget (:func:`nearest_hit_cull_checked` does). t is recomputed
    from the winning sphere with the reference formulation, so autograd
    reaches the scene.
    """
    batch_shape = rays.batch_shape
    o = rays.origin.reshape(-1, 3)
    d = rays.direction.reshape(-1, 3)
    b = o.shape[0]
    with torch.no_grad():
        od, dd = o.detach(), d.detach()
        prays, g, pad = pack_rays(od, dd)
        cand, counts, overflow = tile_candidates(
            _pad_edge(od, pad), _pad_edge(dd, pad), table, max_candidates)
        _, slot = cull_call(prays, cull_tiles(packed, table.num_tiles), cand,
                            counts)
        slot = slot.reshape(-1)[:b]
        idx = torch.where(slot >= 0,
                          packed.prim_idx[torch.clamp(slot, min=0).long()],
                          torch.full_like(slot, -1))
    rec = record_from_ids(o, d, idx, scene).reshape(batch_shape)
    return rec, overflow


@trace.spanned("nearest")
def nearest_hit_cull_checked(rays: Ray, scene: Scene, packed: PackedBVH,
                             table: LeafTable, max_candidates: int = 128):
    """Escalating query: doubles the tile budget until no packet
    overflows or it covers every tile, as the JAX version does. Returns
    (HitRecord, escalations)."""
    n = rays.origin.numel() // 3
    trace.count_outermost(rays=n)
    T = table.num_tiles

    def grow(budgets):
        (k,) = budgets
        return None if k >= T else (min(2 * k, T),)
    return _escalate(lambda k: nearest_hit_cull(rays, scene, packed, table,
                                                k), n, (max_candidates,), grow)
