"""Conservative frustum culling of packets against BVH leaf boxes.

PyTorch counterpart of the table and the interval test of
``tracer/intersect/cull.py``: per-packet bounds (origin box + direction
box) are slab-tested against every leaf AABB at once with interval
arithmetic. The test over-approximates every per-ray slab test, so no
(ray, prim) hit is lost as long as a packet's surviving tiles fit its
budget. Leaves sit in prim-slot order and group into 128-slot tiles, the
unit of the tile-cull walk (``kernels/tilecull.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import Tensor

from tracer_torch.bvh.flat import FlatBVH
from tracer_torch.intersect.sphere import EPSILON

LANES = 128          # prim slots per tile
PACKET = 8 * LANES   # rays per packet in packet_bounds

# Finite stand-in for +/-inf: keeps interval products NaN-free while still
# dwarfing any real scene coordinate.
_BIG = 1.0e18


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
