"""Conservative frustum culling of packets against BVH leaf boxes.

PyTorch counterpart of the table and the interval test of
``tracer/intersect/cull.py``: per-packet bounds (origin box + direction
box) are slab-tested against every leaf AABB at once with interval
arithmetic. The test over-approximates every per-ray slab test, so no
(ray, prim) hit is lost as long as a packet's surviving tiles fit its
budget. Leaves sit in prim-slot order and group into 128-slot tiles, the
unit of the tile-cull walk (``kernels/tilecull.py``) and of the packet cull
(``kernels/cull.py``), whose candidate lists :func:`tile_candidates` makes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import Tensor

from tracer_torch.bvh.flat import FlatBVH
from tracer_torch.intersect.sphere import EPSILON
from tracer_torch.kernels.conecull import compact_ascending_rows

LANES = 128          # prim slots per tile
PACKET = 8 * LANES   # rays per packet in packet_bounds

# Finite stand-in for +/-inf: keeps interval products NaN-free while still
# dwarfing any real scene coordinate.
_BIG = 1.0e18
_BOUNDS_BLOCK = 256  # packets per block of the slab test in packet_tile_hit


@dataclass
class LeafTable:
    """Leaf AABBs in prim-slot order, padded to whole 128-slot tiles.

    leaf_min/leaf_max: (L, 3) f32; leaf i owns prim slots
        [i*leaf_size, (i+1)*leaf_size). Padding leaves hold inverted boxes,
        which the interval test would accept as all-space, so
        ``packet_leaf_hit`` masks leaves >= num_leaves explicitly.
    leaf_size: divides 128, so a tile is a whole number of leaves.
    num_tiles: L * leaf_size // 128.
    num_leaves: count of real leaves.
    """

    leaf_min: Tensor
    leaf_max: Tensor
    leaf_size: int
    num_tiles: int
    num_leaves: int


def build_leaf_table(bvh: FlatBVH) -> LeafTable:
    """Per-leaf AABBs of a FlatBVH in slot order (host, once); tensors on
    the BVH's device."""
    if LANES % bvh.leaf_size:
        raise ValueError("leaf_size must divide 128")
    leaf_start = bvh.leaf_start.cpu().numpy()
    node_min = bvh.node_min.cpu().numpy()
    node_max = bvh.node_max.cpu().numpy()
    is_leaf = leaf_start >= 0
    order = leaf_start[is_leaf] // bvh.leaf_size
    num_leaves = int(order.max()) + 1 if is_leaf.any() else 0
    lpt = LANES // bvh.leaf_size
    L = max(lpt, -(-num_leaves // lpt) * lpt)
    lmin = np.full((L, 3), _BIG, np.float32)
    lmax = np.full((L, 3), -_BIG, np.float32)
    lmin[order] = node_min[is_leaf]
    lmax[order] = node_max[is_leaf]
    dev = bvh.node_min.device
    return LeafTable(leaf_min=torch.as_tensor(lmin, device=dev),
                     leaf_max=torch.as_tensor(lmax, device=dev),
                     leaf_size=bvh.leaf_size,
                     num_tiles=L * bvh.leaf_size // LANES,
                     num_leaves=num_leaves)


def packet_bounds(origin: Tensor, direction: Tensor, packet: int = PACKET):
    """Conservative per-packet bounds: (B, 3) -> four (P, 3) tensors
    (o_lo, o_hi, d_lo, d_hi) over consecutive ``packet``-ray packets."""
    o = origin.reshape(-1, packet, 3)
    d = direction.reshape(-1, packet, 3)
    return o.amin(1), o.amax(1), d.amin(1), d.amax(1)


def _interval_mul(al, ah, bl, bh):
    """[al,ah] * [bl,bh] -> (lo, hi), the exact interval product."""
    p1, p2, p3, p4 = al * bl, al * bh, ah * bl, ah * bh
    lo = torch.minimum(torch.minimum(p1, p2), torch.minimum(p3, p4))
    hi = torch.maximum(torch.maximum(p1, p2), torch.maximum(p3, p4))
    return lo, hi


def packet_leaf_hit(o_lo, o_hi, d_lo, d_hi, table: LeafTable) -> Tensor:
    """Conservative slab test of packet bounds (P, 3) against every leaf
    box: (P, L) bool, True whenever ANY ray within the bounds could satisfy
    the reference AABB acceptance (tmax >= tmin && tmax > EPSILON,
    src/hit.c:81)."""
    lo = table.leaf_min[None, :, :]              # (1, L, 3)
    hi = table.leaf_max[None, :, :]
    o_lo, o_hi = o_lo[:, None, :], o_hi[:, None, :]   # (P, 1, 3)
    d_lo, d_hi = d_lo[:, None, :], d_hi[:, None, :]

    # A direction interval straddling 0 leaves that axis unbounded.
    free = (d_lo <= 0.0) & (d_hi >= 0.0)
    i_lo = 1.0 / torch.where(free, torch.ones_like(d_hi), d_hi)
    i_hi = 1.0 / torch.where(free, torch.ones_like(d_lo), d_lo)

    t1_lo, t1_hi = _interval_mul(lo - o_hi, lo - o_lo, i_lo, i_hi)
    t2_lo, t2_hi = _interval_mul(hi - o_hi, hi - o_lo, i_lo, i_hi)

    tn = torch.where(free, -_BIG, torch.minimum(t1_lo, t2_lo))
    tf = torch.where(free, _BIG, torch.maximum(t1_hi, t2_hi))
    tnear = torch.amax(tn, dim=-1)               # (P, L)
    tfar = torch.amin(tf, dim=-1)
    hit = (tfar >= tnear) & (tfar > EPSILON)
    real = torch.arange(table.leaf_min.shape[0],
                        device=hit.device) < table.num_leaves
    return hit & real[None, :]


def packet_tile_hit(origin: Tensor, direction: Tensor, table: LeafTable,
                    packet: int = PACKET) -> Tensor:
    """(P, T) bool: tile t of the table holds a leaf that packet p's bounds
    slab-hit (:func:`packet_leaf_hit`), for consecutive ``packet``-ray
    packets. The test runs over blocks of packets, so its (P, L, 3)
    temporaries stay small at full batches."""
    T = table.num_tiles
    lpt = LANES // table.leaf_size
    o_lo, o_hi, d_lo, d_hi = packet_bounds(origin, direction, packet)
    P = o_lo.shape[0]
    tile_hit = torch.empty((P, T), dtype=torch.bool, device=origin.device)
    for i in range(0, P, _BOUNDS_BLOCK):
        j = slice(i, i + _BOUNDS_BLOCK)
        hit = packet_leaf_hit(o_lo[j], o_hi[j], d_lo[j], d_hi[j], table)
        tile_hit[j] = hit.reshape(hit.shape[0], T, lpt).any(-1)
    return tile_hit


def prim_tiles(prims: Tensor, w: Tensor, sentinel_w: float,
               num_tiles: int | None = None) -> Tensor:
    """(T+1, 128, 4) f32 prim tiles (cx, cy, cz, w) in slot order, from
    the packed prims (n, 4) (centre, r^2) and the walk's fourth column w
    (n,). T = ``num_tiles``, by default ceil(n / 128). Slots past the n
    prims and the trailing tile T hold the sentinel (0, 0, 0,
    ``sentinel_w``), which the walk's test must reject for every ray."""
    n = prims.shape[0]
    T = -(-n // LANES) if num_tiles is None else num_tiles
    if n > T * LANES:
        raise ValueError(f"{n} prim slots exceed {T} tiles")
    tiles = torch.zeros(((T + 1) * LANES, 4), dtype=torch.float32,
                        device=prims.device)
    tiles[:, 3] = sentinel_w
    tiles[:n, 0:3] = prims[:, 0:3]
    tiles[:n, 3] = w
    return tiles.reshape(T + 1, LANES, 4)


def tile_candidates(origin: Tensor, direction: Tensor, table: LeafTable,
                    max_candidates: int, packet: int = PACKET):
    """Per-packet candidate tile lists: the packet cull's phase A at the
    default 1024-ray packets, the tile cull's at 128-ray subpackets.

    origin/direction: (B, 3), B a multiple of ``packet`` (sorted rays). Returns
    (cand (P, K) i32: the surviving tile ids ascending, then ``num_tiles``;
    counts (P, 1) i32, the raw survivor counts, which may exceed K;
    overflow 0-d bool, some packet had more than K), K =
    min(max_candidates, num_tiles). The JAX version orders survivors with
    top_k on decreasing scores; the row compactor gives the same rows.
    """
    T = table.num_tiles
    K = min(max_candidates, T)
    tile_hit = packet_tile_hit(origin, direction, table, packet)
    tid = torch.arange(T, dtype=torch.int32, device=origin.device)
    masked = torch.where(tile_hit, tid, T).to(torch.int32)
    cand, counts = compact_ascending_rows(masked, T, K)
    overflow = counts.max() > K if counts.numel() else \
        torch.zeros((), dtype=torch.bool, device=origin.device)
    return cand, counts[:, None], overflow
