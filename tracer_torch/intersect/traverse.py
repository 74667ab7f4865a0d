"""Stackless per-ray BVH traversal in plain tensor ops (``--impl traverse``).

PyTorch counterpart of ``tracer/intersect/traverse.py``. The reference walks
its pointer tree recursively per ray (``ray_bvh_intersect``,
src/hit.c:91-109). Here every ray carries one integer cursor into the
escape-indexed preorder layout (``bvh/flat.py``) and the batch advances in
lock-step:

    gather the node box -> slab test -> (leaf? test its leaf_size spheres)
    -> cursor := descend ? node + 1 : escape[node]

with best-t pruning (a box whose interval starts at tmin >= t_best is
skipped) and every sphere of a leaf tested, as in the JAX package. Each step
works only on the rays whose cursor has not finished, so a step costs what
its live rays need rather than the whole batch. This is not a kernel: it is
the JAX package's portable default, in torch ops.
"""

from __future__ import annotations

import torch
from torch import Tensor

from tracer_torch.bvh.flat import FlatBVH, padded_scene_arrays
from tracer_torch.core.types import Ray, HitRecord
from tracer_torch.intersect.aabb import ray_aabb_interval, safe_inv_dir
from tracer_torch.intersect.brute import record_from_ids
from tracer_torch.intersect.sphere import EPSILON, ray_sphere_t
from tracer_torch.scene.scene import Scene


@torch.no_grad()
def traverse_flat(o: Tensor, d: Tensor, node_min: Tensor, node_max: Tensor,
                  escape: Tensor, leaf_start: Tensor, prim_idx: Tensor,
                  centers_p: Tensor, radii_p: Tensor, leaf_size: int):
    """Flat (B, 3) rays against flat BVH tables: (t_best (B,), idx_best
    (B,) i32), +inf and -1 on miss. ``centers_p``/``radii_p`` are the
    sentinel-padded scene arrays (``padded_scene_arrays``). Within a leaf
    the first of equal minima wins, and a later leaf only with a strictly
    smaller t, as ``jnp.argmin`` and the JAX update give."""
    B = o.shape[0]
    M = node_min.shape[0]
    dev = o.device
    inv_d = safe_inv_dir(d)
    node = torch.zeros(B, dtype=torch.int64, device=dev)
    t_best = torch.full((B,), float("inf"), dtype=torch.float32, device=dev)
    idx_best = torch.full((B,), -1, dtype=torch.int32, device=dev)
    lane = torch.arange(leaf_size, device=dev)
    escape = escape.long()
    leaf_start = leaf_start.long()
    prim_idx = prim_idx.long()
    live = torch.arange(B, device=dev)
    while live.numel():
        nn = node[live]
        tmin, tmax = ray_aabb_interval(o[live], inv_d[live], node_min[nn],
                                       node_max[nn])
        box_hit = (tmax >= tmin) & (tmax > EPSILON) & (tmin < t_best[live])
        lstart = leaf_start[nn]
        is_leaf = lstart >= 0
        test = box_hit & is_leaf
        rl = live[test]
        if rl.numel():
            pid = prim_idx[lstart[test][:, None] + lane]          # (n, L)
            t = ray_sphere_t(o[rl][:, None, :], d[rl][:, None, :],
                             centers_p[pid], radii_p[pid])
            t_leaf, j = torch.min(t, dim=1)                        # first min
            better = t_leaf < t_best[rl]
            rb = rl[better]
            t_best[rb] = t_leaf[better]
            idx_best[rb] = torch.gather(pid, 1, j[:, None])[better, 0] \
                .to(torch.int32)
        descend = box_hit & ~is_leaf
        node[live] = torch.where(descend, nn + 1, escape[nn])
        live = live[node[live] < M]
    return t_best, idx_best


def nearest_hit_bvh(rays: Ray, scene: Scene, bvh: FlatBVH) -> HitRecord:
    """Closest hit via the stackless walk; batch shape preserved. t is
    recomputed from the winning id with ``ray_sphere_t`` (the value the walk
    kept), so autograd reaches the scene."""
    batch_shape = rays.batch_shape
    o = rays.origin.reshape(-1, 3)
    d = rays.direction.reshape(-1, 3)
    centers_p, radii_p = padded_scene_arrays(scene.centers.detach(),
                                             scene.radii.detach())
    _, idx = traverse_flat(o.detach(), d.detach(), bvh.node_min,
                           bvh.node_max, bvh.escape, bvh.leaf_start,
                           bvh.prim_idx, centers_p, radii_p, bvh.leaf_size)
    return record_from_ids(o, d, idx, scene).reshape(batch_shape)
