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

from tracer_torch import trace
from tracer_torch.core import vecmath
from tracer_torch.core.sort import prep_rays_bucketed
from tracer_torch.core.types import Ray
from tracer_torch.diff.soft import (SoftParams, _sigmoid, clip,
                                    composite_sorted, maximum, soft_terms)
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

# Device bytes a (ray, candidate) lane of a block holds at the block's
# peak: the forward's planes and those autograd keeps for the backward
# (182 measured on an NVIDIA H100, rounded up).
LANE_BYTES = 192


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
            block_bytes: int):
    """Cut subpackets of ascending ``widths`` (leaves), in that order, into
    blocks (start, stop, leaves): each as many as fit ``block_bytes`` at
    :data:`LANE_BYTES` a lane, as wide as its widest (last) subpacket, at
    least one subpacket and one leaf."""
    lane = subpacket * leaf_size * LANE_BYTES
    out, start = [], 0
    for i, w in enumerate(widths):
        if i > start and (i + 1 - start) * max(w, 1) * lane > block_bytes:
            out.append((start, i, max(widths[i - 1], 1)))
            start = i
    if widths:
        out.append((start, len(widths), max(widths[-1], 1)))
    return out


def _soft_block(centers: Tensor, radii: Tensor, albedo: Tensor, o: Tensor,
                d: Tensor, leaf_ids: Tensor, valid: Tensor,
                tables: CullTables, params: SoftParams, subpacket: int):
    """The exact soft image of one block of subpackets, (p * SP, 3), for
    autograd: each subpacket's candidate spheres (its leaves' slots)
    gathered from the scene, sigma, t_soft and mirror.y in the scalar
    layout (p, SP, K), then each ray's candidates composited in its own
    stable t order (``soft.composite_sorted``); the weights are scattered
    back to the candidates' order, where the shade is read. Also returns
    which of the (p, K) candidate slots hold a real sphere."""
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
    m = real[:, None, :]
    r = torch.where(m, r, torch.ones_like(r))
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
    image in the caller's ray order (no graph); ``grads`` is d loss / d
    (centres, radii, albedo). ``tables`` are single-chunk cull tables,
    their tree built from radii inflated by :func:`soft_radius_scale`
    (widths 30 reach the logit clip of ``soft._sigmoid``: every sphere
    whose sigma is above the clip's floor lies in a candidate leaf).

    Prep runs once (``prep_rays_bucketed`` at ``cell_bits``); phase A
    runs alone, from (max_groups, max_leaves) doubled on each try
    (``leafcull._escalate``, kind "soft", each try the span
    ``tracer_torch.phase_a``), until no subpacket's candidates are
    truncated; the exact per-ray depth-ordered composite then runs once,
    over the subpackets in ascending order of their candidate leaves, cut
    into blocks of at most ``block_bytes`` (:data:`LANE_BYTES` a lane; a
    block is as wide as its widest subpacket), each block's forward and
    backward (the spans ``tracer_torch.composite`` and
    ``tracer_torch.backward``) before the next. Any cut into blocks gives
    the one-block result up to float32 rounding. An evaluation that
    overflows at budgets covering the whole table raises RuntimeError: it
    never returns a truncated image.

    Gradients come through the gathers, whose backward accumulates with
    atomics on CUDA: they are not bitwise run to run on the card.
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
            target = target.reshape(-1, 3).detach()
    leaves = [x.detach().requires_grad_(True)
              for x in (scene.centers, scene.radii, scene.albedo)]
    blocks = _blocks(widths, subpacket, tables.leaf_size, block_bytes)
    trace.count(blocks=len(blocks))
    img = torch.empty((n + 1, 3), dtype=po.dtype, device=po.device)
    loss = torch.zeros((), dtype=po.dtype, device=po.device)
    for start, stop, width in blocks:
        lo, hi = start * subpacket, stop * subpacket
        own = owner[lo:hi]
        with torch.enable_grad():
            with trace.span("composite"):
                img_b, real = _soft_block(
                    *leaves, po[lo:hi], pd[lo:hi],
                    leaf_ids[start:stop, :width], valid[start:stop, :width],
                    tables, params, subpacket)
                keep = (own < n)[:, None]
                if target is None:
                    term = torch.where(keep, img_b, torch.zeros_like(img_b))
                else:
                    diff = img_b - target[torch.clamp(own, max=n - 1)]
                    term = torch.where(keep, diff * diff,
                                       torch.zeros_like(diff))
                loss_b = torch.sum(term) / (3 * n)
                if trace.on():
                    with trace.counting():
                        trace.count(lanes=real.numel() * subpacket,
                                    candidates=real.sum() * subpacket)
            with trace.span("backward"):
                loss_b.backward()
        img[own] = img_b.detach()
        loss += loss_b.detach()
    grads = tuple(torch.zeros_like(x) if x.grad is None else x.grad
                  for x in leaves)
    return loss, img[:n].reshape(*batch_shape, 3), grads, escalations
