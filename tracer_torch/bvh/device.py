"""LBVH construction on the scene's device, in torch ops.

PyTorch counterpart of ``tracer/bvh/device.py``; the large-scene bench
builds its tree this way (the JAX harness does from 5M spheres up):

  1. Morton-encode sphere centers (10 bits per axis) and sort them stably.
  2. Leaves are runs of ``leaf_size`` consecutive prims in Morton order,
     padded to a power-of-two leaf count with sentinel slots.
  3. Internal nodes form a complete binary tree over the leaves; boxes are
     min/max-reduced level by level from the leaves up.
  4. The escape-indexed preorder layout of ``bvh/flat.py`` is emitted in
     closed form: in a complete tree of depth D, node p at depth d has
     preorder index d + sum_i bit_i(p) * (2^(D-i+1) - 1) and escape index
     idx + 2^(D-d+1) - 1. Nodes that cover only padding slots get NaN
     boxes, which fail every slab test.

The uint32 codes live in int64 masked to 30 bits, and the stable sort
reproduces ``jnp.argsort``'s order, so every array equals the JAX build's.
"""

from __future__ import annotations

import torch
from torch import Tensor

from tracer_torch.bvh.flat import FlatBVH

_BIG = 3.0e38


def _expand_bits10(v: Tensor) -> Tensor:
    """Spread 10 bits over 30 (2 zero bits between each); int64."""
    v = v.to(torch.int64) & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_codes_3d(pts: Tensor, lo: Tensor, hi: Tensor) -> Tensor:
    """30-bit Morton codes of points normalized to [lo, hi], (N,) int64."""
    q = (pts - lo) / torch.clamp(hi - lo, min=1e-12)
    q = torch.clamp(q * 1024.0, 0.0, 1023.0).to(torch.int64)
    return (_expand_bits10(q[:, 0]) | (_expand_bits10(q[:, 1]) << 1)
            | (_expand_bits10(q[:, 2]) << 2))


def build_bvh_device(centers: Tensor, radii: Tensor,
                     leaf_size: int = 32) -> FlatBVH:
    """LBVH over spheres, on the device of ``centers``; returns a FlatBVH
    with the same arrays as the JAX ``build_bvh_device``."""
    n = centers.shape[0]
    ls = leaf_size
    dev = centers.device
    if n == 0:
        raise ValueError("cannot build a BVH over an empty scene")

    lo = torch.amin(centers - radii[:, None], dim=0)
    hi = torch.amax(centers + radii[:, None], dim=0)
    order = torch.sort(morton_codes_3d(centers, lo, hi), stable=True).indices

    num_leaves = 1
    while num_leaves * ls < n:
        num_leaves *= 2
    slots = torch.full((num_leaves * ls,), n, dtype=torch.int32, device=dev)
    slots[:n] = order.to(torch.int32)

    # Leaf boxes; padding slots contribute inverted boxes.
    real = slots < n
    safe = torch.where(real, slots, 0).long()
    pmin = torch.where(real[:, None], centers[safe] - radii[safe, None], _BIG)
    pmax = torch.where(real[:, None], centers[safe] + radii[safe, None],
                       -_BIG)
    level_min = [torch.amin(pmin.reshape(num_leaves, ls, 3), dim=1)]
    level_max = [torch.amax(pmax.reshape(num_leaves, ls, 3), dim=1)]
    D = num_leaves.bit_length() - 1
    for _ in range(D):
        level_min.append(torch.amin(level_min[-1].reshape(-1, 2, 3), dim=1))
        level_max.append(torch.amax(level_max[-1].reshape(-1, 2, 3), dim=1))
    level_min.reverse()                     # level_min[d]: (2^d, 3)
    level_max.reverse()

    M = 2 * num_leaves - 1
    node_min = torch.zeros((M, 3), dtype=torch.float32, device=dev)
    node_max = torch.zeros((M, 3), dtype=torch.float32, device=dev)
    escape = torch.zeros((M,), dtype=torch.int32, device=dev)
    leaf_start = torch.full((M,), -1, dtype=torch.int32, device=dev)
    nan = torch.tensor(float("nan"), device=dev)
    for d in range(D + 1):
        p = torch.arange(1 << d, dtype=torch.int64, device=dev)
        idx = torch.full_like(p, d)
        for i in range(1, d + 1):
            idx += ((p >> (d - i)) & 1) * ((1 << (D - i + 1)) - 1)
        has_real = ((p << (D - d)) * ls < n)[:, None]
        node_min[idx] = torch.where(has_real, level_min[d], nan)
        node_max[idx] = torch.where(has_real, level_max[d], nan)
        escape[idx] = (idx + (1 << (D - d + 1)) - 1).to(torch.int32)
        if d == D:
            leaf_start[idx] = (p * ls).to(torch.int32)

    return FlatBVH(node_min=node_min, node_max=node_max, escape=escape,
                   leaf_start=leaf_start, prim_idx=slots, leaf_size=ls)
