"""BVH-sparsified differentiable (soft) rendering.

PyTorch counterpart of ``tracer/diff/sparse.py``. The dense soft renderer
(:mod:`tracer_torch.diff.soft`) scores every ray against every sphere,
O(B*N) forward and backward. This module restricts the soft model to each
ray subpacket's BVH cull candidates (``leafcull.leaf_candidates``), making
the differentiable path O(B*K) with K a few hundred:

  rays --octahedral sort + bucket--> subpackets
  subpackets --hierarchical frustum cull--> <= max_leaves candidate leaves
  leaves --slot tables--> (P, K) candidate sphere ids
  depth-ordered alpha compositing over the gathered (P, SP, K) set

A sphere outside every candidate leaf box of its subpacket has sigma ~ 0,
so the sparse image tends to the dense one while the cull stays
conservative. The soft silhouette reaches a little past the hard radius:
build the cull tables from radii inflated by :func:`soft_radius_scale`.

Gradients reach centres, radii and albedo through the gathers (whose
backward accumulates, with atomics on CUDA, so the sparse gradients are not
bitwise run to run on the card) and the camera pose through the ray values;
the candidate sets are piecewise constant, like the hard path's argmin.

Phase A compacts its rows with the hand-written CUDA compactor on CUDA
tensors (``conecull.compact_ascending_rows``); everything after it is plain
torch with autograd. Deviation from the JAX package:
:func:`soft_render_sparse_fast` selects its top M with ``torch.topk``, which
is exact (recall 1.0) where the JAX function asks ``approx_max_k`` for a
recall target.
"""

from __future__ import annotations

import torch
from torch import Tensor

from tracer_torch.core import vecmath
from tracer_torch.core.sort import prep_rays_bucketed
from tracer_torch.core.types import Ray
from tracer_torch.diff.soft import (SoftParams, _sigmoid, clip,
                                    composite_sorted, maximum, soft_terms)
from tracer_torch.kernels.leafcull import CullTables, leaf_candidates
from tracer_torch.scene.scene import Scene

_PARKED = 1.0e15   # centre of the slots that hold no sphere
_FAR_T = 3.0e38    # soft depth of padding candidates


def soft_radius_scale(params: SoftParams, widths: float = 6.0) -> float:
    """Radius inflation factor so candidate leaf boxes cover the soft
    silhouette skirt: sigma at (1 + widths/sharpness) r is
    sigmoid(-widths) < 3e-3 of the edge value."""
    return 1.0 + widths / float(params.edge_sharpness)


def candidate_leaf_ids(o: Tensor, d: Tensor, tables: CullTables,
                       max_groups: int = 48, max_leaves: int = 16,
                       subpacket: int = 64):
    """Per-subpacket candidate LEAF ids (slot order).

    Returns (leaf_ids (P, max_leaves) i32 zero-padded, valid (P,
    max_leaves) bool, overflow 0-d bool). Group-mode rows list their groups'
    member leaves, truncated to max_leaves: a truncation raises overflow.
    Single-chunk tables only.
    """
    if tables.num_chunks != 1:
        raise ValueError("sparse soft rendering expects single-chunk tables")
    lpg = tables.leaves_per_group
    k = max_leaves
    rows, overflow = leaf_candidates(o, d, tables, max_groups, k, subpacket)
    row = rows[0]                                       # (P, rowlen)
    cnt = row[:, 0]
    j = torch.arange(k, dtype=torch.int32, device=row.device)
    ids_leaf = row[:, 1:k + 1]
    ids_group = row[:, 1 + j // lpg] * lpg + (j % lpg)
    leaf_mode = cnt >= 0
    n_eff = torch.where(leaf_mode, torch.clamp(cnt, max=k),
                        torch.clamp(-cnt * lpg, max=k))
    overflow = overflow | torch.any(~leaf_mode & (-cnt * lpg > k))
    leaf_ids = torch.where(leaf_mode[:, None], ids_leaf, ids_group)
    valid = (j[None, :] < n_eff[:, None]) \
        & (leaf_ids < tables.num_real_leaves) & (leaf_ids >= 0)
    return torch.where(valid, leaf_ids, 0), valid, overflow


def candidate_sphere_ids(o: Tensor, d: Tensor, tables: CullTables,
                         max_groups: int = 48, max_leaves: int = 16,
                         subpacket: int = 64):
    """Per-subpacket candidate sphere ids.

    o/d: (Bp, 3) sorted, bucket-padded rays (``prep_rays_bucketed``).
    Returns (ids (P, K) i32 with -1 padding, overflow 0-d bool) where
    K = max_leaves * leaf_size. Single-chunk tables only.
    """
    ls = tables.leaf_size
    leaf_ids, valid, overflow = candidate_leaf_ids(o, d, tables, max_groups,
                                                   max_leaves, subpacket)
    P = leaf_ids.shape[0]
    slots = leaf_ids[:, :, None] * ls \
        + torch.arange(ls, dtype=torch.int32, device=leaf_ids.device)
    ids = tables.slot_to_sphere[slots.reshape(P, -1).long()]   # (P, K)
    keep = valid[:, :, None].expand(P, max_leaves, ls).reshape(P, -1) \
        & (ids >= 0)
    return torch.where(keep, ids, -1), overflow


def soft_render_sparse_packets(scene: Scene, o: Tensor, d: Tensor,
                               tables: CullTables,
                               params: SoftParams | None = None,
                               max_groups: int = 48, max_leaves: int = 16,
                               subpacket: int = 64):
    """Sparse soft image of sorted, padded rays, (Bp, 3) -> (Bp, 3).

    Returns (img, overflow). Rays must come from ``prep_rays_bucketed``
    (:func:`soft_render_sparse` takes any ray order).
    """
    if params is None:
        params = SoftParams()
    ids, overflow = candidate_sphere_ids(o, d, tables, max_groups,
                                         max_leaves, subpacket)
    P, K = ids.shape
    safe = torch.clamp(ids, min=0).long()
    real = ids >= 0
    centers = scene.centers[safe]                       # (P, K, 3)
    # Padding candidates keep a UNIT radius: a zero radius zeroes eps2 and
    # puts sqrt at exactly 0, whose infinite derivative times the (zero)
    # weight turns into NaN gradients for sphere 0, the safe gather target.
    # The masks below erase padding candidates' values and gradients.
    radii = scene.radii[safe]
    radii = torch.where(real, radii, torch.ones_like(radii))
    albedo = scene.albedo[safe]

    op = o.reshape(P, subpacket, 3)
    dp = d.reshape(P, subpacket, 3)
    sigma, shade, t_soft = soft_terms(op[:, :, None], dp[:, :, None],
                                      centers[:, None], radii[:, None],
                                      albedo[:, None], params)
    # Padding candidates leave the composite: sigma 0, t past every real
    # candidate.
    real = real[:, None, :]
    sigma = torch.where(real, sigma, torch.zeros_like(sigma))
    t_soft = torch.where(real, t_soft, torch.full_like(t_soft, _FAR_T))
    img = composite_sorted(sigma, shade, t_soft, dp)
    return img.reshape(-1, 3), overflow


def soft_render_sparse(scene: Scene, rays: Ray, tables: CullTables,
                       params: SoftParams | None = None,
                       max_groups: int = 48, max_leaves: int = 16,
                       subpacket: int = 64):
    """Differentiable sparse soft image in the caller's ray order.

    Returns (img (batch..., 3), overflow). On overflow call again with a
    larger ``max_leaves``: the candidates were clamped, and the image is an
    approximation on the affected subpackets.
    """
    batch_shape = rays.batch_shape
    flat = Ray(origin=rays.origin.reshape(-1, 3),
               direction=rays.direction.reshape(-1, 3))
    padded, dest = prep_rays_bucketed(flat, subpacket)
    img, overflow = soft_render_sparse_packets(
        scene, padded.origin, padded.direction, tables, params,
        max_groups, max_leaves, subpacket)
    return img[dest].reshape(*batch_shape, 3), overflow


# ---------------------------------------------------------------------------
# Scalar-attribute layout: the leaf-order path and the top-M path
# ---------------------------------------------------------------------------
#
# These keep every hot array 2-D (rays x candidates): candidate leaves are
# gathered as whole leaf_size-wide attribute rows from slot-order tables,
# sigma and t_soft come from scalar broadcast ops, and the composite runs
# along K (leaf order) or over each ray's top M (top-M path).
#
# perp2 is the squared length of the perpendicular vector oc - t_ca d, as
# in ``soft.soft_terms``: the JAX package's |oc|^2 - t_ca^2 |d|^2 cancels
# two terms of size |oc|^2, and hundreds of units from the origin an ulp of
# them is a large part of a small sphere's r^2. Every 3-term sum is spelled
# (x + y) + z, so the card and the CPU round these steps alike.

def slot_attr_tables(scene: Scene, tables: CullTables):
    """Slot-order per-attribute tables (L, leaf_size): cx cy cz r alb0
    alb1 alb2.

    Parked (padding) slots sit at 1e15 with unit radius: sigma underflows
    through the logit clip and t_soft is huge, so they never matter to
    values or gradients.
    """
    ls = tables.leaf_size
    s2s = tables.slot_to_sphere
    safe = torch.clamp(s2s, min=0).long()
    far = s2s < 0
    c = torch.where(far[:, None], torch.full_like(scene.centers[safe],
                                                  _PARKED),
                    scene.centers[safe])
    r = torch.where(far, torch.ones_like(scene.radii[safe]),
                    scene.radii[safe])
    alb = torch.where(far[:, None], torch.zeros_like(scene.albedo[safe]),
                      scene.albedo[safe])
    cols = [c[:, 0], c[:, 1], c[:, 2], r, alb[:, 0], alb[:, 1], alb[:, 2]]
    return [x.reshape(-1, ls) for x in cols]


def _sigma_t_scalar(cx, cy, cz, r, ox, oy, oz, dx, dy, dz, a,
                    params: SoftParams):
    """sigma, t_soft and mirror.y for broadcastable scalar operands: the
    math of ``soft.soft_terms`` in products of scalars. mirror.y is the
    one component of the mirror direction the channel-wise shade needs."""
    inva = 1.0 / maximum(a, 1e-30)
    ocx, ocy, ocz = cx - ox, cy - oy, cz - oz
    t_ca = (ocx * dx + ocy * dy + ocz * dz) * inva
    # The perpendicular vector, without cancellation (see above).
    qx, qy, qz = ocx - t_ca * dx, ocy - t_ca * dy, ocz - t_ca * dz
    perp2 = maximum(qx * qx + qy * qy + qz * qz, 0.0)
    eps2 = (params.smooth_eps * r) ** 2
    perp = torch.sqrt(perp2 + eps2)
    sdf = (perp - r) / maximum(r, 1e-6)
    sigma = _sigmoid(-sdf * params.edge_sharpness)
    disc = r * r - perp2
    sq = torch.sqrt(maximum(disc, 0.0) + eps2) - params.smooth_eps * r
    t_soft = t_ca - sq * torch.sqrt(inva)
    sigma = sigma * _sigmoid(t_soft * params.edge_sharpness)
    # mirror.y = dy - 2 (d.n) ny with n = (o + t d - c) / |o + t d - c|.
    px = ox + t_soft * dx - cx
    py = oy + t_soft * dy - cy
    pz = oz + t_soft * dz - cz
    nn = torch.sqrt(maximum(px * px + py * py + pz * pz, 1e-20))
    nx, ny, nz = px / nn, py / nn, pz / nn
    dn = dx * nx + dy * ny + dz * nz
    my = dy - 2.0 * dn * ny
    return sigma, t_soft, my


def _ray_scalars(op: Tensor, dp: Tensor):
    """(P, SP, 3) rays -> ox, oy, oz, dx, dy, dz, |d|^2, each (P, SP, 1)."""
    ox, oy, oz = (op[:, :, i:i + 1] for i in range(3))
    dx, dy, dz = (dp[:, :, i:i + 1] for i in range(3))
    a = vecmath.dot(dp, dp)[..., None]
    return ox, oy, oz, dx, dy, dz, a


def _sky_channels(y: Tensor):
    """The sky colour keyed to a direction's y, channel by channel, as
    (1 - t) + t * zenith with t = 0.5 (y + 1)."""
    t = 0.5 * (y + 1.0)
    return [(1.0 - t) + t * c for c in (128.0 / 255.0, 178.0 / 255.0, 1.0)]


def leaf_order(o: Tensor, d: Tensor, tables: CullTables, leaf_ids: Tensor,
               lvalid: Tensor, subpacket: int):
    """Sort each subpacket's candidate leaves by the projection of their
    box centres on the packet's mean direction from its mean origin;
    invalid leaves last. Stable, as ``jax.lax.sort``. Returns (leaf_ids,
    lvalid) in that order."""
    P = leaf_ids.shape[0]
    op = o.reshape(P, subpacket, 3)
    dp = d.reshape(P, subpacket, 3)
    o_mean = torch.mean(op, dim=1)                       # (P, 3)
    d_mean = torch.mean(dp, dim=1)
    lc = 0.5 * (tables.leaf_min + tables.leaf_max)       # (L, 3)
    lcg = lc[leaf_ids.long()]                            # (P, max_leaves, 3)
    key = vecmath.dot(lcg - o_mean[:, None], d_mean[:, None])
    key = torch.where(lvalid, key, torch.full_like(key, 3.0e38))
    order = torch.sort(key, dim=1, stable=True).indices
    return (torch.gather(leaf_ids, 1, order),
            torch.gather(lvalid, 1, order))


def soft_render_sparse_leaforder(scene: Scene, o: Tensor, d: Tensor,
                                 tables: CullTables,
                                 params: SoftParams | None = None,
                                 max_groups: int = 48, max_leaves: int = 16,
                                 subpacket: int = 64):
    """Leaf-ordered sparse soft image, (Bp, 3) -> (Bp, 3); returns (img,
    overflow).

    Each subpacket's candidate leaves are sorted once by distance
    (:func:`leaf_order`), their attribute rows gathered in that order, and
    the composite runs directly along K with a cumulative
    log-transmittance: no per-ray sort or selection. The composite order is
    shared per subpacket (leaf granularity, slot order inside a leaf)
    instead of each ray's exact t order; the two differ only where soft
    silhouettes from different leaves overlap one ray at commensurate t.
    """
    if params is None:
        params = SoftParams()
    ls = tables.leaf_size
    K = max_leaves * ls
    leaf_ids, lvalid, overflow = candidate_leaf_ids(
        o, d, tables, max_groups, max_leaves, subpacket)
    leaf_ids, lvalid = leaf_order(o, d, tables, leaf_ids, lvalid, subpacket)
    P = leaf_ids.shape[0]
    op = o.reshape(P, subpacket, 3)
    dp = d.reshape(P, subpacket, 3)

    attrs = slot_attr_tables(scene, tables)
    lid = leaf_ids.long()
    cx, cy, cz, r, a0, a1, a2 = (t[lid].reshape(P, 1, K) for t in attrs)
    kvalid = lvalid[:, :, None].expand(P, max_leaves, ls).reshape(P, 1, K)

    sigma, t_soft, my = _sigma_t_scalar(cx, cy, cz, r,
                                        *_ray_scalars(op, dp), params)
    sigma = torch.where(kvalid, sigma, torch.zeros_like(sigma))

    # Ordered composite along K (leaf-distance order, in-leaf slot order).
    log1m = torch.log1p(-sigma * (1.0 - 1e-6))
    log_t = torch.cumsum(log1m, dim=2) - log1m           # exclusive
    w = sigma * torch.exp(log_t)
    # The shade's sky takes 1 for blue, the background's (1 - t) + t.
    sky = _sky_channels(my)[:2] + [torch.ones_like(my)]
    t_total = torch.exp(torch.sum(log1m, dim=2))         # (P, SP)
    sky_bg = _sky_channels(dp[:, :, 1])
    img = [clip(torch.sum(w * (alb + 0.5 * s), dim=2) + t_total * bg,
                0.0, 1.0)
           for alb, s, bg in zip((a0, a1, a2), sky, sky_bg)]
    return torch.stack(img, dim=-1).reshape(-1, 3), overflow


def soft_render_sparse_fast(scene: Scene, o: Tensor, d: Tensor,
                            tables: CullTables,
                            params: SoftParams | None = None,
                            max_groups: int = 48, max_leaves: int = 16,
                            subpacket: int = 64, top_m: int = 16):
    """Top-M sparse soft image of sorted, padded rays, (Bp, 3) -> (Bp, 3);
    returns (img, overflow).

    The model of :func:`soft_render_sparse_packets` with the composite cut
    to each ray's top M candidates by sigma (error at most the sum of the
    dropped sigmas). The selection is ``torch.topk``: exact, where the JAX
    function's ``approx_max_k`` has a recall target.
    """
    if params is None:
        params = SoftParams()
    ls = tables.leaf_size
    K = max_leaves * ls
    leaf_ids, lvalid, overflow = candidate_leaf_ids(
        o, d, tables, max_groups, max_leaves, subpacket)
    P = leaf_ids.shape[0]
    attrs = slot_attr_tables(scene, tables)
    lid = leaf_ids.long()
    cx, cy, cz, r, a0, a1, a2 = (t[lid].reshape(P, 1, K) for t in attrs)
    kvalid = lvalid[:, :, None].expand(P, max_leaves, ls).reshape(P, 1, K)

    op = o.reshape(P, subpacket, 3)
    dp = d.reshape(P, subpacket, 3)
    sigma, t_soft, my_k = _sigma_t_scalar(cx, cy, cz, r,
                                          *_ray_scalars(op, dp), params)
    sigma = torch.where(kvalid, sigma, torch.zeros_like(sigma))

    B = P * subpacket
    M = min(top_m, K)
    sig_m, idx = torch.topk(sigma.reshape(B, K), M, dim=1)

    def take(x):
        return torch.gather(torch.broadcast_to(x, (P, subpacket, K))
                            .reshape(B, K), 1, idx)
    t_m = take(t_soft)
    my = take(my_k)
    alb_m = [take(x) for x in (a0, a1, a2)]

    # Channel-wise shade of the M survivors.
    shade = [alb + 0.5 * s for alb, s in zip(alb_m, _sky_channels(my))]

    # Exact ordered composite over the M survivors.
    order = torch.argsort(t_m, dim=1, stable=True)
    sig_s = torch.gather(sig_m * (1.0 - 1e-6), 1, order)
    log1m = torch.log1p(-sig_s)
    log_t = torch.cumsum(log1m, dim=1) - log1m
    w_s = sig_s * torch.exp(log_t)
    # Un-sort the weights so that shade is read in its own order.
    inv = torch.argsort(order, dim=1, stable=True)
    w = torch.gather(w_s, 1, inv)
    t_total = torch.exp(torch.sum(log1m, dim=1))[:, None]
    sky_bg = _sky_channels(dp[:, :, 1].reshape(B, 1))
    img = [clip(torch.sum(w * s, dim=1)[:, None] + t_total * bg, 0.0, 1.0)
           for s, bg in zip(shade, sky_bg)]
    return torch.cat(img, dim=1), overflow
