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
tensors (``conecull.compact_ascending_rows``); the image functions after
it are plain torch with autograd. The checked evaluation
(:func:`soft_loss_grad_sparse`) composites and differentiates by hand:
on CUDA tensors in ``csrc/soft.cu``, on CPU tensors in the plain version
of the same arithmetic. Deviation from the JAX package:
:func:`soft_render_sparse_fast` selects its top M with ``torch.topk``, which
is exact (recall 1.0) where the JAX function asks ``approx_max_k`` for a
recall target.
"""

from __future__ import annotations

import torch
from torch import Tensor

from tracer_torch import trace
from tracer_torch.core import vecmath
from tracer_torch.core.sort import prep_rays_bucketed
from tracer_torch.core.types import Ray
from tracer_torch.diff.soft import (SoftParams, _sigmoid, clip,
                                    composite_sorted, maximum, soft_terms)
from tracer_torch.kernels import _lib
from tracer_torch.kernels.leafcull import (CullTables, _doubled_cull_budgets,
                                           _escalate, leaf_candidate_rows,
                                           leaf_candidates)
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
    rows, overflow = leaf_candidates(o, d, tables, max_groups, max_leaves,
                                     subpacket)
    return _leaf_ids(rows, overflow, tables, max_leaves)[:3]


def _leaf_ids(rows: Tensor, overflow: Tensor, tables: CullTables, k: int):
    """Phase A's single-chunk rows -> (leaf_ids, valid, overflow, n_eff),
    :func:`candidate_leaf_ids`' outputs and each subpacket's count of
    listed leaves (P,) i32: its valid leaves all lie in the first n_eff
    columns."""
    lpg = tables.leaves_per_group
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
    return torch.where(valid, leaf_ids, 0), valid, overflow, n_eff


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


_ZENITH = (128.0 / 255.0, 178.0 / 255.0, 1.0)


def _sky_channels(y: Tensor):
    """The sky colour keyed to a direction's y, channel by channel, as
    (1 - t) + t * zenith with t = 0.5 (y + 1)."""
    t = 0.5 * (y + 1.0)
    return [(1.0 - t) + t * c for c in _ZENITH]


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


# ---------------------------------------------------------------------------
# The checked soft evaluation: loss, image and gradients in blocks
# ---------------------------------------------------------------------------
#
# Inverse rendering asks, per step, the loss of the soft image against a
# target and its gradient. The evaluation preps once, runs phase A alone
# under the escalation ladder of the closest-hit drivers
# (``leafcull._escalate``) until no subpacket's candidates are truncated,
# then computes the exact model of :func:`soft_render_sparse_packets`
# (each ray's candidates composited in its own t order) in the scalar
# layout, over blocks of subpackets sized to a byte budget: each block's
# forward, then its backward, before the next. The loss is a sum over
# rays, so the blocks' gradients add up to the whole one's.

# Device bytes a (ray, candidate) lane of a block held at the block's
# peak on the eager autograd path (182 measured on an NVIDIA H100, rounded
# up); the plain version (:func:`soft_composite_plain`, planes of the
# same lanes without autograd) cuts its blocks at it.
LANE_BYTES = 192
# The kernel path's (:func:`soft_composite_cuda`): the (gsigma, w) plane of
# 8 bytes a lane, and a candidate slot's two gathered rows, 32 bytes over
# the subpacket's rays.
KERNEL_LANE_BYTES = 9

def _soft_phase_a(o: Tensor, d: Tensor, tables: CullTables,
                  subpacket: int):
    """:func:`leafcull._escalate`'s query for the soft evaluation: phase A
    at budgets (k0, k) and the read of its overflow and per-subpacket leaf
    counts on the host (the ladder's one sync a try), all in the span
    ``tracer_torch.phase_a``. Returns ((leaf_ids, valid, n_eff as a list,
    overflow), overflow)."""
    def phase_a(k0: int, k: int):
        with trace.span("phase_a"):
            rows, overflow = leaf_candidate_rows(o, d, tables, k0, k,
                                                 subpacket)
            leaf_ids, valid, overflow, n_eff = _leaf_ids(rows, overflow,
                                                         tables, k)
            host = torch.cat([overflow.reshape(1).to(n_eff.dtype),
                              n_eff]).tolist()
        over = bool(host[0])
        return (leaf_ids, valid, host[1:], over), over
    return phase_a


def soft_budgets(tables: CullTables, escalations: int,
                 max_groups: int = 48, max_leaves: int = 16):
    """The (max_groups, max_leaves) at which :func:`soft_loss_grad_sparse`
    composites after ``escalations`` escalations from the asked budgets,
    each at most what covers the single chunk (0: where it starts)."""
    budgets = (min(max_groups, tables.num_groups),
               min(max_leaves, tables.leaves_per_chunk))
    grow = _doubled_cull_budgets(tables)
    for _ in range(escalations):
        budgets = grow(budgets)
    return budgets


def _blocks(widths: list, subpacket: int, leaf_size: int,
            block_bytes: int, lane_bytes: int = LANE_BYTES):
    """Cut subpackets of ascending ``widths`` (leaves), in that order, into
    blocks (start, stop, leaves): each as many as fit ``block_bytes`` at
    ``lane_bytes`` a lane, as wide as its widest (last) subpacket, at
    least one subpacket and one leaf."""
    lane = subpacket * leaf_size * lane_bytes
    out, start = [], 0
    for i, w in enumerate(widths):
        if i > start and (i + 1 - start) * max(w, 1) * lane > block_bytes:
            out.append((start, i, max(widths[i - 1], 1)))
            start = i
    if widths:
        out.append((start, len(widths), max(widths[-1], 1)))
    return out


def _block_candidates(centers: Tensor, radii: Tensor, albedo: Tensor,
                      leaf_ids: Tensor, valid: Tensor, tables: CullTables):
    """A block's candidate slots in the scalar layout: (sid (p, K) with
    the real slots' spheres, real (p, K), attributes cx cy cz r a0 a1 a2
    each (p, 1, K), gathered from the scene at sphere 0 where a slot holds
    no sphere, its radius 1)."""
    p, w = leaf_ids.shape
    ls = tables.leaf_size
    K = w * ls
    slots = leaf_ids[:, :, None] * ls \
        + torch.arange(ls, dtype=torch.int32, device=leaf_ids.device)
    sid = tables.slot_to_sphere[slots.reshape(p, K).long()]
    real = valid[:, :, None].expand(p, w, ls).reshape(p, K) & (sid >= 0)
    safe = torch.where(real, sid, 0).long().reshape(-1)

    # Attribute-major gathers, each (p, 1, K) contiguous; their backward
    # is index_add_ (atomics on CUDA).
    def take(x):
        return torch.index_select(x, -1, safe).reshape(*x.shape[:-1], p,
                                                        1, K)
    cx, cy, cz = take(centers.t())
    a0, a1, a2 = take(albedo.t())
    # Padding candidates keep a unit radius (see
    # soft_render_sparse_packets); the masks erase them.
    r = take(radii)
    r = torch.where(real[:, None, :], r, torch.ones_like(r))
    return safe, real, (cx, cy, cz, r, a0, a1, a2)


def _soft_block(centers: Tensor, radii: Tensor, albedo: Tensor, o: Tensor,
                d: Tensor, leaf_ids: Tensor, valid: Tensor,
                tables: CullTables, params: SoftParams, subpacket: int):
    """The exact soft image of one block of subpackets, (p * SP, 3), for
    autograd: each subpacket's candidate spheres (its leaves' slots)
    gathered from the scene, sigma, t_soft and mirror.y in the scalar
    layout (p, SP, K), then each ray's candidates composited in its own
    stable t order (``soft.composite_sorted``); the weights are scattered
    back to the candidates' order, where the shade is read. Also returns
    which of the (p, K) candidate slots hold a real sphere. The oracle of
    the plain version and the kernel (:func:`soft_composite_plain`,
    :func:`soft_composite_cuda`)."""
    p = leaf_ids.shape[0]
    _, real, (cx, cy, cz, r, a0, a1, a2) = _block_candidates(
        centers, radii, albedo, leaf_ids, valid, tables)
    m = real[:, None, :]
    op = o.reshape(p, subpacket, 3)
    dp = d.reshape(p, subpacket, 3)
    sigma, t_soft, my = _sigma_t_scalar(cx, cy, cz, r, *_ray_scalars(op, dp),
                                        params)
    sigma = torch.where(m, sigma, torch.zeros_like(sigma))
    t_soft = torch.where(m, t_soft, torch.full_like(t_soft, _FAR_T))

    order = torch.argsort(t_soft, dim=2, stable=True)
    sig_s = torch.gather(sigma * (1.0 - 1e-6), 2, order)
    log1m = torch.log1p(-sig_s)
    log_t = torch.cumsum(log1m, dim=2) - log1m          # exclusive
    w_s = sig_s * torch.exp(log_t)
    wgt = torch.zeros_like(w_s).scatter(2, order, w_s)
    t_total = torch.exp(torch.sum(log1m, dim=2))        # (p, SP)
    # The shade's sky takes 1 for blue, the background's (1 - t) + t.
    sky = _sky_channels(my)[:2] + [torch.ones_like(my)]
    sky_bg = _sky_channels(dp[:, :, 1])
    img = [clip(torch.sum(wgt * (a + 0.5 * s), dim=2) + t_total * bg,
                0.0, 1.0)
           for a, s, bg in zip((a0, a1, a2), sky, sky_bg)]
    return torch.stack(img, dim=-1).reshape(-1, 3), real


# ---------------------------------------------------------------------------
# The composite's hand-written backward: the plain version of csrc/soft.cu
# ---------------------------------------------------------------------------
#
# The loss is a sum over rays, each ray's image a clipped sum over its
# candidates in its own stable t order:
#
#   s_i = sigma_i (1 - 1e-6),  L_i = log1p(-s_i),  E_i = sum_{k<i} L_k,
#   w_i = s_i exp(E_i),  T = exp(sum_k L_k),
#   x_c = sum_i w_i shade_ic + T bg_c,  img_c = clip(x_c, 0, 1).
#
# With g_c = d loss / d img_c (clip's 0.5 on either bound),
# G_i = sum_c g_c shade_ic and the reverse scan
# R_i = sum_{k>i} w_k G_k + T sum_c g_c bg_c,
#
#   d loss / d s_i = exp(E_i) G_i - R_i / (1 - s_i),
#   d loss / d albedo_ic = g_c w_i,
#   d loss / d mirror.y_i = w_i (0.25 sum_{c<2} g_c (z_c - 1)),
#
# z the sky's zenith colour; sigma and mirror.y then go back to the centre
# and radius through :func:`_lane_backward`, lane by lane. The forward
# (:func:`_lane_forward`) is ``_sigma_t_scalar``'s operations in its
# order, each rounded once, and keeps what the backward reads; maxima and
# clips give half the gradient at a tie, as ``soft.maximum`` does.

_KEEP = 1.0 - 1e-6
# d loss / d mirror.y over w: 0.25 sum_{c<2} g_c (z_c - 1).
_MY_TERMS = (_ZENITH[0] - 1.0, _ZENITH[1] - 1.0)


def _tie(x: Tensor, c: float) -> Tensor:
    """d maximum(x, c) / dx: 1 above c, 0.5 at it, 0 below."""
    return torch.where(x > c, 1.0, torch.where(x == c, 0.5, 0.0))


def _sig_parts(x: Tensor):
    """``soft._sigmoid(x)`` with what its derivative reads: (v, e, y) for
    v = -x before the clip, e = exp(clip(v, -30, 30)), y = 1 / (1 + e)."""
    v = -x
    e = torch.exp(clip(v, -30.0, 30.0))
    return v, e, 1.0 / (1.0 + e)


def _sig_grad(gy: Tensor, v: Tensor, e: Tensor, y: Tensor) -> Tensor:
    """d loss / dx of y = sigmoid(x) from d loss / dy: gy y^2 e times the
    clip's derivative at v = -x."""
    return gy * (y * y) * e * (_tie(v, -30.0) * _tie(-v, -30.0))


def _lane_forward(cx, cy, cz, r, ox, oy, oz, dx, dy, dz, a,
                  params: SoftParams) -> dict:
    """sigma, t_soft and mirror.y of broadcastable scalar operands, as
    :func:`_sigma_t_scalar` computes them, with the values the backward
    reads (a dict of tensors)."""
    es, se = params.edge_sharpness, params.smooth_eps
    f = {}
    inva = 1.0 / maximum(a, 1e-30)
    ocx, ocy, ocz = cx - ox, cy - oy, cz - oz
    t_ca = (ocx * dx + ocy * dy + ocz * dz) * inva
    qx, qy, qz = ocx - t_ca * dx, ocy - t_ca * dy, ocz - t_ca * dz
    qq = qx * qx + qy * qy + qz * qz
    perp2 = maximum(qq, 0.0)
    ser = se * r
    eps2 = ser * ser
    perp = torch.sqrt(perp2 + eps2)
    mr = maximum(r, 1e-6)
    sdf = (perp - r) / mr
    v1, e1, y1 = _sig_parts(-sdf * es)
    disc = r * r - perp2
    h = torch.sqrt(maximum(disc, 0.0) + eps2)
    sinva = torch.sqrt(inva)
    t = t_ca - (h - ser) * sinva
    v2, e2, y2 = _sig_parts(t * es)
    px = ox + t * dx - cx
    py = oy + t * dy - cy
    pz = oz + t * dz - cz
    pp = px * px + py * py + pz * pz
    nn = torch.sqrt(maximum(pp, 1e-20))
    nx, ny, nz = px / nn, py / nn, pz / nn
    dn = dx * nx + dy * ny + dz * nz
    my = dy - 2.0 * dn * ny
    f.update(inva=inva, sinva=sinva, qx=qx, qy=qy, qz=qz, qq=qq, ser=ser,
             perp=perp, mr=mr, sdf=sdf, v1=v1, e1=e1, y1=y1, disc=disc, h=h,
             t=t, v2=v2, e2=e2, y2=y2, px=px, py=py, pz=pz, pp=pp, nn=nn,
             nx=nx, ny=ny, nz=nz, dn=dn, sigma=y1 * y2, my=my, r=r)
    return f


def _lane_backward(f: dict, dx, dy, dz, gsig: Tensor, gmy: Tensor,
                   params: SoftParams):
    """d loss / d (cx, cy, cz, r) of every lane from d loss / d sigma and
    d loss / d mirror.y, by the chain rule through :func:`_lane_forward`
    (``csrc/soft.cu`` ``lane_backward`` in the same steps)."""
    es, se = params.edge_sharpness, params.smooth_eps
    r, nn = f["r"], f["nn"]
    # sigma = y1 y2; x1 = -sdf es; x2 = t es.
    gx1 = _sig_grad(gsig * f["y2"], f["v1"], f["e1"], f["y1"])
    gx2 = _sig_grad(gsig * f["y1"], f["v2"], f["e2"], f["y2"])
    gt = gx2 * es
    # sdf = (perp - r) / max(r, 1e-6).
    gnum = -(gx1 * es) / f["mr"]
    gr = -gnum - gnum * f["sdf"] * _tie(r, 1e-6)
    # perp = sqrt(perp2 + eps2).
    gpe = gnum * 0.5 / f["perp"]
    # mirror.y = dy - (2 dn) ny; dn = d . n; n = p / nn.
    gdn = -2.0 * gmy * f["ny"]
    gnx = gdn * dx
    gny = gdn * dy - gmy * (2.0 * f["dn"])
    gnz = gdn * dz
    gnn = -(gnx * f["nx"] + gny * f["ny"] + gnz * f["nz"]) / nn
    gpp = gnn * 0.5 / nn * _tie(f["pp"], 1e-20)
    gpx = gnx / nn + 2.0 * f["px"] * gpp
    gpy = gny / nn + 2.0 * f["py"] * gpp
    gpz = gnz / nn + 2.0 * f["pz"] * gpp
    # p = o + t d - c; t = t_ca - (h - se r) sinva.
    gt = gt + (gpx * dx + gpy * dy + gpz * dz)
    gsq = -gt * f["sinva"]
    gh = gsq * 0.5 / f["h"]
    gdisc = gh * _tie(f["disc"], 0.0)
    # disc = r^2 - perp2; eps2 = (se r)^2.
    gr = gr - gsq * se + 2.0 * r * gdisc \
        + (gpe + gh) * 2.0 * f["ser"] * se
    gqq = (gpe - gdisc) * _tie(f["qq"], 0.0)
    gqx, gqy, gqz = (2.0 * f[k] * gqq for k in ("qx", "qy", "qz"))
    # q = oc - t_ca d; t_ca = (oc . d) inva; oc = c - o.
    gdot = (gt - (gqx * dx + gqy * dy + gqz * dz)) * f["inva"]
    return (gqx + gdot * dx - gpx, gqy + gdot * dy - gpy,
            gqz + gdot * dz - gpz, gr)


def _loss_grads(x: list, own: Tensor, target: Tensor | None, n: int):
    """The per-ray loss terms (sum over channels, 0 on bucket padding) and
    d loss / d x_c (each (p, SP)) of the pre-clip channels ``x``: the mean
    of (img - target)^2, or of img where ``target`` is None, over n rays
    and 3 channels."""
    keep = own < n
    scale = 1.0 / (3 * n)
    img = [clip(xc, 0.0, 1.0) for xc in x]
    if target is None:
        terms, dimg = img, [torch.ones_like(xc) for xc in x]
    else:
        tgt = target[torch.clamp(own, max=n - 1)]
        diff = [ic - tgt[..., c] for c, ic in enumerate(img)]
        terms = [df * df for df in diff]
        dimg = [2.0 * df for df in diff]
    cd = [_tie(xc, 0.0) * _tie(-torch.clamp(xc, min=0.0), -1.0) for xc in x]
    g = [torch.where(keep, di * scale * ci, torch.zeros_like(di))
         for di, ci in zip(dimg, cd)]
    term = torch.where(keep, terms[0] + terms[1] + terms[2],
                       torch.zeros_like(terms[0]))
    return torch.stack(img, dim=-1), term, g


def soft_composite_plain(scene: Scene, o: Tensor, d: Tensor,
                         leaf_ids: Tensor, valid: Tensor, widths: list,
                         own: Tensor, target: Tensor | None, n: int,
                         tables: CullTables, params: SoftParams,
                         subpacket: int):
    """The plain version of :func:`soft_composite_cuda`, in torch without
    autograd over the block's (p, SP, K) lanes: its image rows (p * SP,
    3), the sum of its rays' loss terms (0-d; the loss is that over 3 n),
    each subpacket's count of real candidates (p,), and what
    :func:`soft_backward_plain` reads. Padding slots carry sigma 0 and t
    past every real candidate, so they add exactly 0; ``widths`` is not
    read."""
    p = leaf_ids.shape[0]
    safe, real, (cx, cy, cz, r, a0, a1, a2) = _block_candidates(
        scene.centers, scene.radii, scene.albedo, leaf_ids, valid, tables)
    m = real[:, None, :]
    op = o.reshape(p, subpacket, 3)
    dp = d.reshape(p, subpacket, 3)
    ray = _ray_scalars(op, dp)
    f = _lane_forward(cx, cy, cz, r, *ray, params)
    t = torch.where(m, f["t"], torch.full_like(f["t"], _FAR_T))
    s = torch.where(m, f["sigma"] * _KEEP, torch.zeros_like(f["sigma"]))
    # The shade's sky takes 1 for blue, as in _soft_block.
    sky = _sky_channels(f["my"])
    shade = [a0 + 0.5 * sky[0], a1 + 0.5 * sky[1], a2 + 0.5]

    order = torch.argsort(t, dim=2, stable=True)
    s_s = torch.gather(s, 2, order)
    log1m = torch.log1p(-s_s)
    csum = torch.cumsum(log1m, dim=2)
    e_s = torch.exp(torch.cat([torch.zeros_like(csum[..., :1]),
                               csum[..., :-1]], dim=2))   # exp(E), exclusive
    w_s = s_s * e_s
    w = torch.zeros_like(w_s).scatter(2, order, w_s)
    t_total = torch.exp(csum[..., -1])                    # (p, SP)
    bg = _sky_channels(dp[:, :, 1])
    x = [torch.sum(w * sc, dim=2) + t_total * b for sc, b in zip(shade, bg)]
    img, term, g = _loss_grads(x, own.reshape(p, subpacket), target, n)

    # The reverse scan, in each ray's t order.
    big_g = sum(gc[..., None] * sc for gc, sc in zip(g, shade))
    wg = w_s * torch.gather(big_g, 2, order)
    suffix = torch.flip(torch.cumsum(torch.flip(wg, [2]), dim=2), [2])
    r_s = torch.cat([suffix[..., 1:], torch.zeros_like(suffix[..., :1])],
                    dim=2) + (t_total * sum(gc * b for gc, b in zip(g, bg))
                              )[..., None]
    ds = e_s * torch.gather(big_g, 2, order) - r_s / (1.0 - s_s)
    gsig = torch.zeros_like(ds).scatter(2, order, ds * _KEEP)
    gsig = torch.where(m, gsig, torch.zeros_like(gsig))
    state = (f, ray, gsig, w, g, safe, real)
    return img.reshape(-1, 3), torch.sum(term), real.sum(1), state


def soft_backward_plain(state, grads, params: SoftParams) -> None:
    """The plain version of :func:`soft_backward_cuda`: each lane's
    derivatives (:func:`_lane_backward`), summed over the subpacket's
    rays, then added into ``grads`` (centres (N, 3), radii (N,), albedo
    (N, 3)) at the real candidates' spheres."""
    f, ray, gsig, w, g, safe, real = state
    _, _, _, dx, dy, dz, _ = ray
    gmy = w * (0.25 * (g[0] * _MY_TERMS[0] + g[1] * _MY_TERMS[1]))[..., None]
    gc = _lane_backward(f, dx, dy, dz, gsig, gmy, params)
    m = real[:, None, :]
    keep = real.reshape(-1)
    idx = safe[keep]

    def add(into: Tensor, lanes: Tensor):
        lanes = torch.where(m, lanes, torch.zeros_like(lanes))
        into.index_add_(0, idx, torch.sum(lanes, dim=1).reshape(-1)[keep])
    for c in range(3):
        add(grads[0][:, c], gc[c])
        add(grads[2][:, c], g[c][..., None] * w)
    add(grads[1], gc[3])


# ---------------------------------------------------------------------------
# The kernel path (csrc/soft.cu)
# ---------------------------------------------------------------------------

# Keys a team sorts in shared memory: above this a ray's keys go to
# device memory.
_SHARED_KEYS = 16384
_MAX_SUBPACKET = 128    # soft.cu kMaxSP: the backward's rows of rays
SOFT_CHUNK = 128        # soft.cu kChunk: candidates a backward CTA


def _pow2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


def soft_layouts(caps: list):
    """Phase 1's launches for subpackets of ascending candidate capacities
    ``caps`` (leaves times leaf size): runs [start, stop) that share a key
    capacity (a power of two at least 256, the run's largest) and a team
    per ray, as (start, stop, team, teams a CTA, key capacity, keys in
    shared memory). A warp a ray up to 2,048 keys, 8 rays a CTA up to
    1,024 and 4 at 2,048 (64 KB of keys); above, the CTA's 256 threads a
    ray, the keys in shared memory up to ``_SHARED_KEYS`` (128 KB), in
    device memory past it."""
    out = []
    for i, cap in enumerate(caps):
        kcap = max(256, _pow2(cap))
        team, teams = (32, 8 if kcap <= 1024 else 4) if kcap <= 2048 \
            else (256, 1)
        layout = (team, teams, kcap, kcap <= _SHARED_KEYS)
        if out and tuple(out[-1][2:]) == layout:
            out[-1][1] = i + 1
        else:
            out.append([i, i + 1, *layout])
    return [tuple(x) for x in out]


def _check_soft_args(scene: Scene, o: Tensor, d: Tensor, leaf_ids: Tensor,
                     valid: Tensor, widths: list, own: Tensor,
                     target: Tensor | None, n: int, tables: CullTables,
                     subpacket: int) -> torch.device:
    """The device of :func:`soft_composite_cuda`'s tensors; raises on any
    other device, dtype, shape or layout than its kernels take."""
    p = leaf_ids.shape[0]
    rows = p * subpacket
    want = [(scene.centers, torch.float32, (scene.centers.shape[0], 3)),
            (scene.radii, torch.float32, (scene.centers.shape[0],)),
            (scene.albedo, torch.float32, (scene.centers.shape[0], 3)),
            (o, torch.float32, (rows, 3)), (d, torch.float32, (rows, 3)),
            (own, torch.int64, (rows,)),
            (tables.slot_to_sphere, torch.int32, None)]
    if target is not None:
        want.append((target, torch.float32, (n, 3)))
    for t, dtype, shape in want:
        if t.dtype != dtype or (shape is not None and tuple(t.shape) != shape):
            raise ValueError(f"soft_cuda: a {t.dtype} tensor of shape "
                             f"{tuple(t.shape)}, wants {dtype} {shape}")
        if not t.is_contiguous():
            raise ValueError("soft_cuda: a tensor is not contiguous")
    if leaf_ids.dtype != torch.int32 or valid.dtype != torch.bool \
            or leaf_ids.shape != valid.shape or leaf_ids.dim() != 2 \
            or leaf_ids.stride(1) != 1 or leaf_ids.stride() != valid.stride():
        raise ValueError("soft_cuda: leaf_ids (p, w) int32 and valid (p, w) "
                         "bool, rows of one stride, columns of unit stride")
    if len(widths) != p or (p and max(widths) > leaf_ids.shape[1]):
        raise ValueError(f"soft_cuda: {len(widths)} widths for {p} rows of "
                         f"{leaf_ids.shape[1]} leaves")
    if not 1 <= subpacket <= _MAX_SUBPACKET or n < 1:
        raise ValueError(f"soft_cuda: subpacket {subpacket} outside "
                         f"1..{_MAX_SUBPACKET}, or {n} rays")
    if subpacket * tables.leaf_size * sum(widths) >= 2 ** 31:
        raise ValueError("soft_cuda: the block's lanes pass 2^31")
    return _lib.require_cuda("soft_cuda", leaf_ids, valid,
                             *(t for t, _, _ in want))


def soft_composite_cuda(scene: Scene, o: Tensor, d: Tensor,
                        leaf_ids: Tensor, valid: Tensor, widths: list,
                        own: Tensor, target: Tensor | None, n: int,
                        tables: CullTables, params: SoftParams,
                        subpacket: int):
    """The composite of a block of subpackets as hand-written CUDA
    (``csrc/soft.cu``): one launch gathers each subpacket's real
    candidates (its ``widths`` leaves' slots that hold a sphere; padding
    dropped), then one launch a layout (:func:`soft_layouts`) takes each
    ray's candidates, sorts their t stably, composites them, forms the
    ray's loss term and d loss / d image, and runs the reverse scan to
    d loss / d sigma of each candidate (the (gsigma, w) plane). Returns
    the block's image rows, the sum of its rays' loss terms, each
    subpacket's count of real candidates and what
    :func:`soft_backward_cuda` reads. Raises for tensors the kernels do
    not take; allocates with ``torch.empty``."""
    dev = _check_soft_args(scene, o, d, leaf_ids, valid, widths, own,
                           target, n, tables, subpacket)
    p = leaf_ids.shape[0]
    ls = tables.leaf_size
    caps = [w * ls for w in widths]
    off = [0]
    for c in caps:
        off.append(off[-1] + c)
    off_t = torch.tensor(off, dtype=torch.int32).to(dev)
    slots = max(off[-1], 1)
    cand = torch.empty((slots, 4), dtype=torch.float32, device=dev)
    alb = torch.empty((slots, 4), dtype=torch.float32, device=dev)
    count = torch.empty(p, dtype=torch.int32, device=dev)
    _lib.launch("soft_cuda", "tracer_soft_gather", dev, leaf_ids, valid,
                tables.slot_to_sphere, scene.centers, scene.radii,
                scene.albedo, off_t, cand, alb, count, leaf_ids.stride(0),
                ls, p)
    rows = p * subpacket
    own32 = own.to(torch.int32)
    img = torch.empty((rows, 3), dtype=torch.float32, device=dev)
    term = torch.empty(rows, dtype=torch.float32, device=dev)
    gray = torch.empty((rows, 4), dtype=torch.float32, device=dev)
    plane = torch.empty((subpacket * slots, 2), dtype=torch.float32,
                        device=dev)
    es, se = float(params.edge_sharpness), float(params.smooth_eps)
    layouts = soft_layouts(caps)
    for start, stop, team, teams, kcap, shared in layouts:
        while subpacket % teams:
            teams //= 2
        keys = None if shared else torch.empty(
            (stop - start) * subpacket * kcap, dtype=torch.int64, device=dev)
        _lib.launch("soft_cuda", "tracer_soft_rays", dev, cand, alb, off_t,
                    count, o, d, own32, target, img, term, gray, plane, keys,
                    start, stop - start, team, teams, kcap, subpacket, n, es,
                    se, 1.0 / (3 * n))
    state = (cand, alb, off_t, count, o, d, gray, plane, layouts, caps, es,
             se, subpacket)
    return img, torch.sum(term), count, state


def soft_backward_cuda(state, grads, params: SoftParams) -> None:
    """The composite's backward as hand-written CUDA: one launch a layout
    of :func:`soft_composite_cuda`, a thread a candidate over the
    subpacket's rays (each lane's derivatives from the (gsigma, w)
    plane), then one atomic add a (subpacket, candidate, attribute) into
    ``grads`` (centres (N, 3), radii (N,), albedo (N, 3), float32,
    contiguous)."""
    (cand, alb, off_t, count, o, d, gray, plane, layouts, caps, es, se,
     subpacket) = state
    for g in grads:
        if g.dtype != torch.float32 or not g.is_contiguous():
            raise ValueError("soft_cuda: gradients are float32, contiguous")
    dev = _lib.require_cuda("soft_cuda", cand, *grads)
    for start, stop, *_ in layouts:
        chunks = -(-max(caps[stop - 1], 1) // SOFT_CHUNK)
        _lib.launch("soft_cuda", "tracer_soft_grads", dev, cand, alb, off_t,
                    count, o, d, gray, plane, *grads, start, stop - start,
                    chunks, subpacket, es, se)


def soft_paths(kernel: bool):
    """(composite, backward, bytes a lane) of the kernels or of their
    plain versions."""
    if kernel:
        return soft_composite_cuda, soft_backward_cuda, KERNEL_LANE_BYTES
    return soft_composite_plain, soft_backward_plain, LANE_BYTES


@trace.spanned("soft")
def soft_loss_grad_sparse(scene: Scene, rays: Ray, target: Tensor | None,
                          tables: CullTables,
                          params: SoftParams | None = None,
                          max_groups: int = 48, max_leaves: int = 16,
                          subpacket: int = 64, cell_bits: int = 8,
                          block_bytes: int = 4 << 30):
    """One checked inverse-rendering evaluation: (loss, image, grads,
    escalations).

    ``loss`` (0-d) is the mean squared difference of the soft image and
    ``target`` (batch..., 3) over every ray and channel, or the image's
    mean where ``target`` is None; ``image`` (batch..., 3) is the soft
    image in the caller's ray order; ``grads`` is d loss / d (centres,
    radii, albedo). ``tables`` are single-chunk cull tables, their tree
    built from radii inflated by :func:`soft_radius_scale` (widths 30
    reach the logit clip of ``soft._sigmoid``: every sphere whose sigma is
    above the clip's floor lies in a candidate leaf).

    Prep runs once (``prep_rays_bucketed`` at ``cell_bits``); phase A
    runs alone, from (max_groups, max_leaves) doubled on each try
    (``leafcull._escalate``, kind "soft", each try the span
    ``tracer_torch.phase_a``), until no subpacket's candidates are
    truncated; the exact per-ray depth-ordered composite then runs once,
    over the subpackets in ascending order of their candidate leaves, cut
    into blocks of at most ``block_bytes`` (a block is as wide as its
    widest subpacket), each block's composite and backward (the spans
    ``tracer_torch.composite`` and ``tracer_torch.backward``) before the
    next. CUDA tensors take the kernels (:func:`soft_composite_cuda`,
    :func:`soft_backward_cuda`, :data:`KERNEL_LANE_BYTES` a lane), CPU
    tensors their plain versions (:func:`soft_composite_plain`,
    :func:`soft_backward_plain`, :data:`LANE_BYTES` a lane); neither uses
    autograd, and the trace counts which ran as ``soft_kernel``. Any cut
    into blocks gives the one-block result up to float32 rounding. An
    evaluation that overflows at budgets covering the whole table raises
    RuntimeError: it never returns a truncated image.

    The gradients are added up with atomics on CUDA: they are not bitwise
    run to run on the card.
    """
    if params is None:
        params = SoftParams()
    if tables.num_chunks != 1:
        raise ValueError("sparse soft rendering expects single-chunk tables")
    batch_shape = rays.batch_shape
    o = rays.origin.reshape(-1, 3).detach()
    d = rays.direction.reshape(-1, 3).detach()
    n = o.shape[0]
    trace.count(rays=n)
    with torch.no_grad():
        with trace.span("prep"):
            padded, dest = prep_rays_bucketed(Ray(origin=o, direction=d),
                                              subpacket, cell_bits)
        po, pd = padded.origin, padded.direction
        (leaf_ids, valid, n_eff, over), escalations = _escalate(
            _soft_phase_a(po, pd, tables, subpacket), n,
            soft_budgets(tables, 0, max_groups, max_leaves),
            _doubled_cull_budgets(tables), kind="soft")
        if over:
            raise RuntimeError("the soft evaluation's candidates overflow "
                               "budgets that cover the whole table")
        # The subpackets in ascending order of their leaves, so that a
        # block is about as wide as each of its subpackets; each padded
        # slot's caller ray (n for bucket padding: the image's spare row).
        P = leaf_ids.shape[0]
        order = sorted(range(P), key=n_eff.__getitem__)
        widths = [n_eff[i] for i in order]
        perm = torch.as_tensor(order, device=po.device)
        owner = torch.full((po.shape[0],), n, dtype=torch.long,
                           device=po.device)
        owner[dest] = torch.arange(n, device=po.device)
        owner = owner.reshape(P, subpacket)[perm].reshape(-1)
        po = po.reshape(P, subpacket, 3)[perm].reshape(-1, 3)
        pd = pd.reshape(P, subpacket, 3)[perm].reshape(-1, 3)
        leaf_ids, valid = leaf_ids[perm], valid[perm]
        if target is not None:
            target = target.reshape(-1, 3).detach().contiguous()
    kernel = po.device.type != "cpu"
    composite, backward, lane_bytes = soft_paths(kernel)
    ls = tables.leaf_size
    blocks = _blocks(widths, subpacket, ls, block_bytes, lane_bytes)
    trace.count(blocks=len(blocks))
    grads = tuple(torch.zeros_like(x) for x in
                  (scene.centers, scene.radii, scene.albedo))
    img = torch.empty((n + 1, 3), dtype=po.dtype, device=po.device)
    loss = torch.zeros((), dtype=po.dtype, device=po.device)
    with torch.no_grad():
        for start, stop, width in blocks:
            lo, hi = start * subpacket, stop * subpacket
            own = owner[lo:hi]
            with trace.span("composite"):
                img_b, term, real, state = composite(
                    scene, po[lo:hi], pd[lo:hi],
                    leaf_ids[start:stop, :width], valid[start:stop, :width],
                    widths[start:stop], own, target, n, tables, params,
                    subpacket)
                trace.count(soft_kernel=int(kernel))
                if trace.on():
                    with trace.counting():
                        trace.count(lanes=sum(widths[start:stop]) * ls
                                    * subpacket,
                                    candidates=real.sum() * subpacket)
            with trace.span("backward"):
                backward(state, grads, params)
            img[own] = img_b
            loss += term / (3 * n)
    return loss, img[:n].reshape(*batch_shape, 3), grads, escalations
