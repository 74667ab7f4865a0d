"""Ring scene sharding: closest hit over sphere shards passed around a ring.

PyTorch counterpart of ``tracer/dist/ring.py``. For scenes too large to
replicate, the sphere arrays shard across a mesh axis and stay resident;
ray blocks rotate around the ring instead, ring attention's KV rotation
with the softmax accumulation replaced by a (t, index) min-reduction:

    step s on rank k: test the resident sphere shard k against the ray
    block that started on rank (k - s) mod P, fold (t, index) into that
    block's running best with a strict <, then send the block and its
    running best to rank k + 1 and receive from rank k - 1.

After P steps every block has visited every shard and is back on its home
rank with the global closest hit; one all-gather then gives every rank the
whole batch's. Each step moves O(rays) data whatever the scene size. The
send and the receive of a step are one ``batch_isend_irecv``; with P = 1
there is no step to send (a rank cannot send to itself), and the ring is
the unsharded brute force (or the one shard's walk).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
from torch import Tensor
from torch.distributed.device_mesh import DeviceMesh

from tracer_torch.bvh.builder import build_bvh
from tracer_torch.bvh.flat import padded_scene_arrays
from tracer_torch.core.device import default_device
from tracer_torch.core.types import HitRecord, Ray
from tracer_torch.dist.mesh import (SCENE_AXIS, all_gather_cat, axis_group,
                                    shard_rows)
from tracer_torch.intersect.sphere import hit_record_from_t, ray_sphere_t
from tracer_torch.intersect.traverse import traverse_flat
from tracer_torch.scene.scene import Scene

# Finite "never hit" node-box padding: inverted boxes whose slab interval
# is always empty (tmax < tmin), without inf arithmetic.
_PAD_BOX = 3.0e37


@dataclass
class ShardedBVH:
    """Per-shard flat BVHs, stacked and padded to a common size.

    Each shard's BVH covers its contiguous sphere range, so a ring step
    costs O(block * log(N/P)) instead of the brute O(block * N/P).

    node_min/node_max: (P, M, 3) f32; escape/leaf_start: (P, M) i32;
    prim_idx: (P, S) i32 in shard-local sphere indices, padded slots hold
    ``shard_size`` (the per-shard sentinel). Padding nodes (the shards'
    trees differ in size) are inverted boxes with escape = M and
    leaf_start = -1, and escapes to a shard's "done" retarget to M.
    """

    node_min: Tensor
    node_max: Tensor
    escape: Tensor
    leaf_start: Tensor
    prim_idx: Tensor
    shard_size: int
    leaf_size: int


def build_sharded_bvh(centers, radii, num_shards: int, leaf_size: int = 8,
                      device=None, **build_kw) -> ShardedBVH:
    """Build one BVH per contiguous sphere shard (on the host, once).

    Sphere i lives on shard i // (n / num_shards), the split the ring gives
    the scene arrays, so shard-local prim ids map to global ids by adding
    the shard's offset. The tables go to the CUDA device unless ``device``
    names another.
    """
    device = default_device(device)
    centers = np.asarray(torch.as_tensor(centers).cpu(), np.float32)
    radii = np.asarray(torch.as_tensor(radii).cpu(), np.float32)
    n = len(radii)
    if n % num_shards:
        raise ValueError(f"spheres {n} must divide {num_shards} shards")
    ssz = n // num_shards
    parts = [build_bvh(centers[s * ssz:(s + 1) * ssz],
                       radii[s * ssz:(s + 1) * ssz], leaf_size=leaf_size,
                       device="cpu", **build_kw)
             for s in range(num_shards)]
    m = max(p.num_nodes for p in parts)
    slots = max(p.prim_idx.shape[0] for p in parts)

    def pad(x, k, value):
        return torch.cat([x, torch.full((k, *x.shape[1:]), value,
                                        dtype=x.dtype)])

    cols = []
    for p in parts:
        k = m - p.num_nodes
        esc = pad(p.escape, k, m)
        cols.append((pad(p.node_min, k, _PAD_BOX),
                     pad(p.node_max, k, -_PAD_BOX),
                     torch.where(esc >= p.num_nodes, m, esc),
                     pad(p.leaf_start, k, -1),
                     pad(p.prim_idx, slots - p.prim_idx.shape[0], ssz)))
    nmin, nmax, esc, lst, pidx = (torch.stack(x).to(device)
                                  for x in zip(*cols))
    return ShardedBVH(node_min=nmin, node_max=nmax,
                      escape=esc.to(torch.int32),
                      leaf_start=lst.to(torch.int32),
                      prim_idx=pidx.to(torch.int32), shard_size=ssz,
                      leaf_size=leaf_size)


def _local_best(o: Tensor, d: Tensor, centers: Tensor, radii: Tensor,
                offset: int):
    """Brute-force best (t, global index) of a ray block against a sphere
    shard; the first of equal minima wins."""
    t = ray_sphere_t(o[:, None, :], d[:, None, :], centers[None], radii[None])
    j = torch.argmin(t, dim=-1)
    tb = torch.gather(t, 1, j[:, None])[:, 0]
    return tb, (j + offset).to(torch.int32)


def _local_best_bvh(o: Tensor, d: Tensor, centers: Tensor, radii: Tensor,
                    offset: int, tables, leaf_size: int):
    """BVH-walked best (t, global index) against the resident shard's tree
    (``tables``: its node_min, node_max, escape, leaf_start, prim_idx)."""
    centers_p, radii_p = padded_scene_arrays(centers, radii)
    tb, ib = traverse_flat(o, d, *tables, centers_p, radii_p, leaf_size)
    ib = torch.where(ib >= 0, ib + offset, ib)
    tb = torch.where(ib >= 0, tb, torch.full_like(tb, float("inf")))
    return tb, ib


@torch.no_grad()
def nearest_hit_ring(rays: Ray, scene: Scene, mesh: DeviceMesh,
                     axis: str = SCENE_AXIS,
                     sbvh: ShardedBVH | None = None) -> HitRecord:
    """Closest hit with both rays and spheres sharded over ``axis``.

    ``rays``: any batch shape whose ray count divides by the axis size;
    ``scene``: the FULL scene (each rank takes its shard). With ``sbvh``
    (:func:`build_sharded_bvh`, the same number of shards) each ring step
    walks the resident shard's BVH instead of testing every sphere. Returns
    the HitRecord of the unsharded brute force on every rank.
    """
    group, me, p = axis_group(mesh, axis)
    n = scene.num_spheres
    if n % p:
        raise ValueError(f"spheres {n} must divide scene shards {p}")
    ssz = n // p
    if sbvh is not None and sbvh.shard_size != ssz:
        raise ValueError(f"sbvh shard size {sbvh.shard_size} != {ssz}")
    o = rays.origin.reshape(-1, 3)
    d = rays.direction.reshape(-1, 3)
    centers = shard_rows(scene.centers, me, p)
    radii = shard_rows(scene.radii, me, p)
    offset = me * ssz
    tables = None if sbvh is None else (
        sbvh.node_min[me], sbvh.node_max[me], sbvh.escape[me],
        sbvh.leaf_start[me], sbvh.prim_idx[me])
    nxt = dist.get_global_rank(group, (me + 1) % p)
    prv = dist.get_global_rank(group, (me - 1) % p)

    ob, db = shard_rows(o, me, p), shard_rows(d, me, p)
    tb = torch.full((ob.shape[0],), float("inf"), dtype=torch.float32,
                    device=o.device)
    ib = torch.full((ob.shape[0],), -1, dtype=torch.int32, device=o.device)
    for _ in range(p):
        if tables is None:
            t_new, i_new = _local_best(ob, db, centers, radii, offset)
        else:
            t_new, i_new = _local_best_bvh(ob, db, centers, radii, offset,
                                           tables, sbvh.leaf_size)
        better = t_new < tb
        tb = torch.where(better, t_new, tb)
        ib = torch.where(better, i_new, ib)
        if p == 1:
            break
        # The block and its running best go to rank + 1; the block of
        # rank - 1 arrives. After p moves every block is home again.
        send = torch.cat([ob, db, tb[:, None]], dim=1)
        recv, ri = torch.empty_like(send), torch.empty_like(ib)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, send, nxt, group, tag=0),
                dist.P2POp(dist.isend, ib, nxt, group, tag=1),
                dist.P2POp(dist.irecv, recv, prv, group, tag=0),
                dist.P2POp(dist.irecv, ri, prv, group, tag=1)]):
            req.wait()
        ob, db, tb, ib = recv[:, 0:3], recv[:, 3:6], recv[:, 6], ri
    tb = all_gather_cat(tb.contiguous(), group)
    ib = all_gather_cat(ib, group)
    tb = torch.where(ib >= 0, tb, torch.full_like(tb, float("inf")))
    rec = hit_record_from_t(Ray(origin=o, direction=d), tb, ib,
                            scene.centers)
    return rec.reshape(rays.batch_shape)
