"""Packet traversal of the escape-index BVH (``--impl pallas``).

PyTorch counterpart of ``tracer/kernels/traverse_pallas.py``. Rays go in
packets of 1024 that share one traversal cursor: the packet descends into a
node when ANY of its rays' slab intervals starts before that ray's best t,
tests a leaf's ``leaf_size`` prims against all 1024 rays, and otherwise
skips to the node's escape index. The walk returns the argmin prim slot per
ray and the packet's visited-node count (``steps``).

The walk is a hand-written CUDA kernel on CUDA tensors (``traverse_cuda``,
``csrc/traverse.cu``) and a plain PyTorch version with the same contract on
CPU tensors (``traverse_plain``); :func:`traverse_call` picks by device and
raises for any other. Both spell the same f32 operations in the same
order (no FMA contraction, correctly rounded sqrt), so they agree bit for
bit: t, slots and steps.

The kernel walks in two launches: one CTA per packet up to ``STEP_CAP``
steps, then thread-block clusters of ``CLUSTER`` CTAs, each holding
1024 / CLUSTER of the packet's rays, resume the packets still walking (on
bounce rays, the few whose rays span the scene). The walk's state (cursor,
steps, each ray's best t and slot) is all a resumed walk needs, so the cut
changes nothing; ``traverse_plain(..., caps=...)`` cuts its walk the same
way and the tests hold it to the whole walk.

The leaf test is the b-form of the JAX kernel (b = 2 oc.d, c = |oc|^2 - r^2,
disc = b^2 - 4ac, t = (-b - sqrt(disc)) / 2a), not the u-form of the leaf
walks; the kernel returns slots only, and :func:`nearest_hit_bvh_packets`
recomputes t from the winning sphere so gradients reach the scene.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import Tensor

from tracer_torch import trace
from tracer_torch.bvh.flat import FlatBVH, padded_scene_arrays
from tracer_torch.core.types import Ray
from tracer_torch.intersect.brute import record_from_ids
from tracer_torch.intersect.sphere import EPSILON
from tracer_torch.kernels import _lib
from tracer_torch.kernels.leafcull import _pad_edge, _sqrt_rn
from tracer_torch.scene.scene import Scene

PACKET = 1024          # rays per packet
RAY_COLS = 8           # per-ray columns: ox oy oz dx dy dz 0 0
_HUGE = 3.0e38         # 1/d stand-in where d == 0
# The kernel's split, the fastest in an on-card sweep of caps 64/256/1024
# and clusters of 1-16 CTAs on the render's walks: the first launch's step
# cap and the resume launch's cluster size (1, 2, 4, 8 or 16).
STEP_CAP = 256
CLUSTER = 8


@dataclass
class PackedBVH:
    """Kernel tables of a FlatBVH and its scene (build once per scene).

    nodes:    (M, 8) f32 -- box min xyz, 0, box max xyz, 0 (two float4)
    links:    (M, 4) i32 -- escape (next cursor on a miss or after a leaf),
              next cursor on a hit (node + 1 inside, escape at a leaf),
              first prim slot of a leaf (-1 inside), 0
    prims:    (P, 4) f32 -- center xyz and radius^2 per prim slot; sentinel
              slots hold the far sentinel sphere, which nothing hits
    prim_idx: (P,) i32 prim slot -> sphere id (N for sentinel slots)
    """

    nodes: Tensor
    links: Tensor
    prims: Tensor
    prim_idx: Tensor
    num_nodes: int
    leaf_size: int

    @property
    def esc(self) -> Tensor:
        return self.links[:, 0]

    @property
    def nxt(self) -> Tensor:
        return self.links[:, 1]

    @property
    def lstart(self) -> Tensor:
        return self.links[:, 2]


def pack_bvh(scene: Scene, bvh: FlatBVH) -> PackedBVH:
    """Pack a FlatBVH and its scene into the walk's tables, on the scene's
    device."""
    dev = scene.centers.device
    nmin = bvh.node_min.to(dev, torch.float32)
    nmax = bvh.node_max.to(dev, torch.float32)
    z = torch.zeros_like(nmin[:, :1])
    nodes = torch.cat([nmin, z, nmax, z], dim=1)
    esc = bvh.escape.to(dev, torch.int32)
    lstart = bvh.leaf_start.to(dev, torch.int32)
    order = torch.arange(bvh.num_nodes, dtype=torch.int32, device=dev)
    nxt = torch.where(lstart >= 0, esc, order + 1)
    links = torch.stack([esc, nxt, lstart, torch.zeros_like(esc)], dim=1)
    centers_p, radii_p = padded_scene_arrays(scene.centers.detach(),
                                             scene.radii.detach())
    pidx = bvh.prim_idx.to(dev).long()
    r = radii_p[pidx]
    prims = torch.cat([centers_p[pidx], (r * r)[:, None]], dim=1)
    return PackedBVH(nodes=nodes.contiguous(), links=links.contiguous(),
                     prims=prims.contiguous(),
                     prim_idx=bvh.prim_idx.to(dev, torch.int32),
                     num_nodes=bvh.num_nodes, leaf_size=bvh.leaf_size)


def pack_rays(o: Tensor, d: Tensor):
    """(B, 3) rays -> ((g, PACKET, 8) packed rays, g, pad). Padding rays
    replicate the last real ray, so a partly padded packet stays coherent."""
    b = o.shape[0]
    g = -(-b // PACKET)
    pad = g * PACKET - b
    rows = torch.cat([o, d, torch.zeros_like(o[:, :2])], dim=1)
    rows = _pad_edge(rows.to(torch.float32), pad)
    return rows.reshape(g, PACKET, RAY_COLS), g, pad


def _check_args(rays: Tensor, packed: PackedBVH) -> None:
    if rays.dim() != 3 or tuple(rays.shape[1:]) != (PACKET, RAY_COLS) \
            or rays.dtype != torch.float32:
        raise ValueError(f"rays must be (g, {PACKET}, {RAY_COLS}) float32, "
                         f"got {tuple(rays.shape)} {rays.dtype}")
    M = packed.num_nodes
    if tuple(packed.nodes.shape) != (M, 8) or tuple(
            packed.links.shape) != (M, 4) or packed.prims.shape[1:] != (4,):
        raise ValueError("packed tables do not match num_nodes")
    if packed.links.dtype != torch.int32 or packed.nodes.dtype \
            != torch.float32 or packed.prims.dtype != torch.float32:
        raise ValueError("nodes/prims must be float32 and links int32")


def _ray_terms(rays: Tensor):
    """Per-ray (o, d, 1/d, a, 1/(2a)) components, as the kernel rounds them."""
    o = [rays[..., k] for k in range(3)]
    d = [rays[..., 3 + k] for k in range(3)]
    inv = [torch.where(x == 0.0, torch.full_like(x, _HUGE),
                       1.0 / torch.where(x == 0.0, torch.ones_like(x), x))
           for x in d]
    a = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    inv2a = 1.0 / (2.0 * torch.clamp(a, min=1e-30))
    return o, d, inv, a, inv2a


@torch.no_grad()
def traverse_plain(rays: Tensor, packed: PackedBVH,
                   leaf_visits: bool = False, caps=()):
    """Plain PyTorch packet walk: the contract of ``traverse_cuda``.

    rays (g, PACKET, 8) f32 from :func:`pack_rays`. Returns (t (g, PACKET)
    f32, +inf on miss; slot (g, PACKET) i32 prim slot, -1 on miss; steps
    (g,) i32 nodes visited per packet), and with ``leaf_visits`` also the
    (g,) i32 count of leaves each packet tested.

    All packets walk at once with a (g,) cursor; each step slab-tests the
    (live packets, PACKET) rays against their packets' nodes, then tests
    the leaves that some ray of the packet reached. Within a leaf the first
    of equal minima wins and a later prim only with a strictly smaller t,
    as the kernel's in-order strict update gives.

    ``caps`` (ascending step counts) cut the walk as the kernel's launches
    do: it stops every packet at each cap in turn and resumes from the
    state (best t and slot per ray, cursor and steps per packet) alone.
    The result does not depend on them.
    """
    _check_args(rays, packed)
    state = _walk_start(rays)
    terms = _ray_terms(rays)
    for cap in (*caps, None):
        _walk_steps(terms, packed, state, cap)
    tb, ib, _, steps, leaves = state
    if leaf_visits:
        return tb, ib, steps, leaves
    return tb, ib, steps


def _walk_start(rays: Tensor):
    """The walk's state before its first step: (best t (g, PACKET) +inf,
    best slot -1, cursor (g,) 0, steps 0, leaf visits 0)."""
    g = rays.shape[0]
    dev = rays.device
    return (torch.full((g, PACKET), float("inf"), dtype=torch.float32,
                       device=dev),
            torch.full((g, PACKET), -1, dtype=torch.int32, device=dev),
            torch.zeros(g, dtype=torch.int64, device=dev),
            torch.zeros(g, dtype=torch.int32, device=dev),
            torch.zeros(g, dtype=torch.int32, device=dev))


def _walk_steps(terms, packed: PackedBVH, state, cap=None) -> None:
    """Advance the walk ``state`` in place until every packet has left the
    tree or walked ``cap`` steps (None: no cap)."""
    o, d, inv, a, inv2a = terms
    tb, ib, cursor, steps, leaves = state
    M = packed.num_nodes
    ls = packed.leaf_size
    links = packed.links.long()
    lane = torch.arange(ls, device=tb.device)
    live = torch.nonzero(cursor < M).reshape(-1)
    if cap is not None:
        live = live[steps[live] < cap]
    while live.numel():
        cur = cursor[live]
        nd = packed.nodes[cur]                                 # (n, 8)
        t1 = [(nd[:, k, None] - o[k][live]) * inv[k][live] for k in range(3)]
        t2 = [(nd[:, 4 + k, None] - o[k][live]) * inv[k][live]
              for k in range(3)]
        lo = [torch.fmin(x, y) for x, y in zip(t1, t2)]
        hi = [torch.fmax(x, y) for x, y in zip(t1, t2)]
        tmin = torch.fmax(lo[0], torch.fmax(lo[1], lo[2]))
        tmax = torch.fmin(hi[0], torch.fmin(hi[1], hi[2]))
        box = (tmax >= tmin) & (tmax > EPSILON) & (tmin < tb[live])
        any_hit = box.any(dim=1)
        ln = links[cur]
        at_leaf = any_hit & (ln[:, 2] >= 0)
        pl = live[at_leaf]
        if pl.numel():
            slot = ln[at_leaf, 2, None] + lane                 # (n, ls)
            q = packed.prims[slot]                             # (n, ls, 4)
            t = _bform_t(*(x[pl][:, :, None] for x in (*o, *d, a, inv2a)),
                         *(q[:, None, :, k] for k in range(4)))
            tl, j = torch.min(t, dim=2)                        # first min
            better = tl < tb[pl]
            tb[pl] = torch.where(better, tl, tb[pl])
            ib[pl] = torch.where(better, torch.gather(slot, 1, j)
                                 .to(torch.int32), ib[pl])
            leaves[pl] += 1
        cursor[live] = torch.where(any_hit, ln[:, 1], ln[:, 0])
        steps[live] += 1
        keep = cursor[live] < M
        if cap is not None:
            keep &= steps[live] < cap
        live = live[keep]


def _bform_t(ox, oy, oz, dx, dy, dz, a, inv2a, cx, cy, cz, rsq):
    """t of the near root where disc > 0 and t > EPSILON, else +inf; the
    kernel's b-form, op for op."""
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    bq = 2.0 * (ocx * dx + ocy * dy + ocz * dz)
    cq = ocx * ocx + ocy * ocy + ocz * ocz - rsq
    disc = bq * bq - (4.0 * a) * cq
    t = (-bq - _sqrt_rn(torch.clamp(disc, min=0.0))) * inv2a
    ok = (disc > 0.0) & (t > EPSILON)
    return torch.where(ok, t, torch.full_like(t, float("inf")))


def traverse_cuda(rays: Tensor, packed: PackedBVH):
    """The packet walk as the hand-written CUDA kernel
    (``csrc/traverse.cu``): one CTA of 1024 threads per packet for up to
    ``STEP_CAP`` steps, then clusters of ``CLUSTER`` CTAs resume the
    packets still walking.

    Same arguments and (t, slot, steps) outputs as :func:`traverse_plain`.
    Raises for tensors that are not on one CUDA device, and when the card
    refuses a launch. Reads no device value on the host.
    """
    dev = _lib.require_cuda("traverse_cuda", rays, packed.nodes,
                            packed.links, packed.prims)
    _check_args(rays, packed)
    if not 1 <= packed.leaf_size <= 32:
        raise ValueError(f"leaf_size {packed.leaf_size} not in 1..32")
    g = rays.shape[0]
    rays = rays.contiguous()
    t = torch.empty((g, PACKET), dtype=torch.float32, device=dev)
    slot = torch.empty((g, PACKET), dtype=torch.int32, device=dev)
    steps = torch.empty((g,), dtype=torch.int32, device=dev)
    scratch = torch.empty((1 + 2 * g,), dtype=torch.int32, device=dev)
    _lib.launch("traverse_cuda", "tracer_traverse", dev, rays, packed.nodes,
                packed.links, packed.prims, t, slot, steps, scratch, g,
                packed.num_nodes, packed.leaf_size, CLUSTER, STEP_CAP)
    return t, slot, steps


@trace.spanned("walk")
def traverse_call(rays: Tensor, packed: PackedBVH):
    """(t, slot, steps) of the packet walk. CPU tensors run
    :func:`traverse_plain`; anything else goes to :func:`traverse_cuda`,
    which launches the kernel or raises.

    Where the trace is on it counts ``packets``, ``packet_steps`` (the sum
    of ``steps``) and ``resumed_packets``, those past ``STEP_CAP`` steps:
    the packets ``traverse_cuda``'s resume launch walks (its first launch
    lists a packet still inside the tree at the cap, so one that walked
    more than ``STEP_CAP`` steps). A few small launches.
    """
    out = (traverse_plain(rays, packed) if rays.device.type == "cpu"
           else traverse_cuda(rays, packed))
    if trace.on():
        steps = out[2]
        with trace.counting():
            trace.count(packets=steps.numel(), packet_steps=steps.sum(),
                        resumed_packets=(steps > STEP_CAP).sum())
    return out


@trace.spanned("nearest")
def nearest_hit_bvh_packets(rays: Ray, scene: Scene, packed: PackedBVH,
                            with_steps: bool = False):
    """Closest hit via the packet walk; batch shape preserved. The
    counterpart of the JAX package's ``nearest_hit_bvh_pallas``.

    Returns a HitRecord, and with ``with_steps`` also the visited-node count
    of each ray's packet (batch shape, i32). The walk gives the winning prim
    slot; the sphere id comes from ``packed.prim_idx`` and t is recomputed
    from it with the reference formulation, so autograd reaches the scene.
    """
    batch_shape = rays.batch_shape
    o = rays.origin.reshape(-1, 3)
    d = rays.direction.reshape(-1, 3)
    b = o.shape[0]
    trace.count_outermost(rays=b)
    with torch.no_grad():
        packed_rays, g, _ = pack_rays(o.detach(), d.detach())
        if g:
            _, slot, steps = traverse_call(packed_rays, packed)
        else:
            slot = torch.zeros((0, PACKET), dtype=torch.int32,
                               device=o.device)
            steps = torch.zeros((0,), dtype=torch.int32, device=o.device)
        slot = slot.reshape(-1)[:b]
        idx = torch.where(slot >= 0,
                          packed.prim_idx[torch.clamp(slot, min=0).long()],
                          torch.full_like(slot, -1))
    rec = record_from_ids(o, d, idx, scene).reshape(batch_shape)
    if with_steps:
        per_ray = steps.repeat_interleave(PACKET)[:b]
        return rec, per_ray.reshape(batch_shape)
    return rec
