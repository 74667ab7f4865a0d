"""Phase A of the queries, the row compactor, and the hybrid closest-hit
and any-hit (shadow) queries.

PyTorch counterpart of the shipped half of ``tracer/kernels/conecull.py``:
per-subpacket interval bounds from the feature planes, slab tests against
group boxes and then against the member leaves of surviving groups, and
count-embedded candidate rows per (subpacket, chunk) with a group-mode
fallback and an overflow flag. Rows, counts and overflow equal the JAX
package's for the same tables and features.

The compactor is ``compact_cuda`` (hand-written CUDA, ``csrc/compact.cu``)
on CUDA tensors and ``compact_ascending_rows_plain`` on CPU tensors;
:func:`compact_ascending_rows` picks by device and raises for any other.
The JAX cone construction (``cone_from_feats``) feeds only the unshipped
phase-B kernel and is not ported: :func:`cone_candidates` returns ``None``
in its place.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import Tensor

from tracer_torch.bvh.flat import FlatBVH
from tracer_torch.core.types import Ray
from tracer_torch.intersect.sphere import EPSILON
from tracer_torch.kernels import _lib
from tracer_torch.kernels.leafcull import (CullTables, anyhit_call,
                                           build_cull_tables, leafcull_call,
                                           pack_ray_features, _NOSLOT)
from tracer_torch.scene.scene import Scene

# Row and prefix widths are rounded to this many ids exactly as in the JAX
# package, so that every row has the same length and padding on both sides.
_ROW_ALIGN = 128


@dataclass
class ConeTables:
    """CullTables plus attr-major leaf-box rows and the max prim radius.

    leaf_boxes: (Gc, lpg*6) f32 member-leaf AABBs per group row:
                [lpg lox | loy | loz | hix | hiy | hiz].
    r_max:      max prim radius.
    """

    cull: CullTables
    leaf_boxes: Tensor
    r_max: float


def build_cone_tables(scene: Scene, bvh: FlatBVH,
                      leaves_per_group: int = 16,
                      max_chunk_bytes: int = 9 << 20) -> ConeTables:
    cull = build_cull_tables(scene, bvh, leaves_per_group=leaves_per_group,
                             max_chunk_bytes=max_chunk_bytes)
    lpg = cull.leaves_per_group
    lo = cull.leaf_min.reshape(-1, lpg, 3)
    hi = cull.leaf_max.reshape(-1, lpg, 3)
    rows = torch.cat([lo[:, :, a] for a in range(3)]
                     + [hi[:, :, a] for a in range(3)], dim=1)
    r_max = float(scene.radii.max()) if scene.radii.numel() else 0.0
    return ConeTables(cull=cull, leaf_boxes=rows.contiguous(), r_max=r_max)


# ---------------------------------------------------------------------------
# Phase A
# ---------------------------------------------------------------------------

def _reduce_feats(feats: Tensor, red) -> Tensor:
    """Reduce (G, S, SP, FEAT) over SP -> (P, FEAT)."""
    return red(feats, dim=2).reshape(-1, feats.shape[-1])


def bounds_from_feats(feats: Tensor):
    """Per-subpacket o/d interval bounds (o_lo, o_hi, d_lo, d_hi), each
    (P, 3), from the feature planes (columns 0-2 = d, 3-5 = -2o)."""
    lo = _reduce_feats(feats, torch.amin)
    hi = _reduce_feats(feats, torch.amax)
    return hi[:, 3:6] * -0.5, lo[:, 3:6] * -0.5, lo[:, 0:3], hi[:, 0:3]


def _slab_hit_cols(o_lo, o_hi, d_lo, d_hi, blo, bhi) -> Tensor:
    """Conservative interval slab test, (P, M) bool.

    o_lo/o_hi/d_lo/d_hi: (P, 3) subpacket bounds; blo/bhi: 3-tuples of
    (1|P, M) box coordinates. True whenever ANY ray inside the bounds
    could satisfy the reference AABB acceptance (tmax >= tmin &&
    tmax > EPSILON, src/hit.c:81).
    """
    big = 1.0e18
    tnear, tfar = None, None
    for a in range(3):
        dl, dh = d_lo[:, a:a + 1], d_hi[:, a:a + 1]
        ol, oh = o_lo[:, a:a + 1], o_hi[:, a:a + 1]
        free = (dl <= 0.0) & (dh >= 0.0)
        i_lo = 1.0 / torch.where(free, torch.ones_like(dh), dh)
        i_hi = 1.0 / torch.where(free, torch.ones_like(dl), dl)

        def imul(al, ah, bl, bh):
            p1, p2, p3, p4 = al * bl, al * bh, ah * bl, ah * bh
            return (torch.minimum(torch.minimum(p1, p2),
                                  torch.minimum(p3, p4)),
                    torch.maximum(torch.maximum(p1, p2),
                                  torch.maximum(p3, p4)))

        t1_lo, t1_hi = imul(blo[a] - oh, blo[a] - ol, i_lo, i_hi)
        t2_lo, t2_hi = imul(bhi[a] - oh, bhi[a] - ol, i_lo, i_hi)
        tn = torch.where(free, -big, torch.minimum(t1_lo, t2_lo))
        tf = torch.where(free, big, torch.maximum(t1_hi, t2_hi))
        tnear = tn if tnear is None else torch.maximum(tnear, tn)
        tfar = tf if tfar is None else torch.minimum(tfar, tf)
    return (tfar >= tnear) & (tfar > EPSILON)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pad_cols(x: Tensor, width: int, value: int) -> Tensor:
    """Right-pad (..., K) to (..., width) with ``value`` (no-op if K >= width)."""
    extra = width - x.shape[-1]
    if extra <= 0:
        return x
    return torch.cat([x, torch.full((*x.shape[:-1], extra), value,
                                    dtype=x.dtype, device=x.device)], dim=-1)


def cone_candidates(feats: Tensor, tables: ConeTables, max_groups: int,
                    max_candidates: int):
    """Phase A: feature planes -> per-(subpacket, chunk) candidate rows.

    Returns (rows (C, P, rowlen) i32, None, overflow 0-d bool tensor). A row
    is [count, ids...] padded with the chunk's leaf count: count > 0 lists
    chunk-relative leaf ids, count < 0 lists -count chunk-relative group ids
    (group mode, when the leaf budget or the group refine overflowed), and
    overflow is set when a group-mode row itself was truncated. The second
    output stands where the JAX function returns its cones, which only the
    unshipped phase-B kernel reads; it is always None here. No host sync.
    """
    cull = tables.cull
    lpg = cull.leaves_per_group
    lpc = cull.leaves_per_chunk
    C = cull.num_chunks
    G = cull.num_groups
    dev = feats.device
    k0 = _round_up(min(max_groups, G), 8)
    k = min(max_candidates, lpc)
    rowlen = _round_up(k + 17, _ROW_ALIGN)

    o_lo, o_hi, d_lo, d_hi = bounds_from_feats(feats)
    P = o_lo.shape[0]

    # Dense level: slab test against every group box.
    gm, gM = cull.group_min, cull.group_max
    ghit = _slab_hit_cols(o_lo, o_hi, d_lo, d_hi,
                          tuple(gm[None, :, a] for a in range(3)),
                          tuple(gM[None, :, a] for a in range(3)))
    gids = torch.arange(G, dtype=torch.int32, device=dev)
    ghit = ghit & (gids * lpg < cull.num_real_leaves)[None, :]
    gids = gids[None, :].expand(P, G)

    Gpad = _round_up(G, _ROW_ALIGN)
    gm_ids = _pad_cols(torch.where(ghit, gids, G), Gpad, G)
    K0 = min(Gpad, max(_round_up(k0, _ROW_ALIGN), 4 * _ROW_ALIGN))
    gprefix, gtotal = compact_ascending_rows(gm_ids, G, K0)
    gcand = _pad_cols(gprefix[:, :k0], k0, G)

    # Refine: slab test against the member leaves of surviving groups.
    rows_lb = tables.leaf_boxes[torch.clamp(gcand, max=G - 1).long()]
    att = [rows_lb[:, :, a * lpg:(a + 1) * lpg].reshape(P, -1)
           for a in range(6)]                            # 6 x (P, k0*lpg)
    member = (gcand[:, :, None] * lpg
              + torch.arange(lpg, dtype=torch.int32, device=dev)) \
        .reshape(P, -1)
    valid = member < cull.num_real_leaves
    lhit = _slab_hit_cols(o_lo, o_hi, d_lo, d_hi,
                          tuple(att[0:3]), tuple(att[3:6])) & valid

    gpc = lpc // lpg
    kg = min(gpc, rowlen - 9)
    refine_truncated = gtotal > k0

    K_l = min(member.shape[1], 4 * _ROW_ALIGN)
    lprefix, ltotal = compact_ascending_rows(
        torch.where(lhit, member, C * lpc), C * lpc, K_l)

    j = torch.arange(max(k, kg), dtype=torch.int32, device=dev)

    def chunk_rows(prefix, per_chunk, budget):
        """C == 1: the chunk's row is a plain slice of the global prefix."""
        cnt = torch.sum(prefix < per_chunk, dim=1, dtype=torch.int32)[:, None]
        head = _pad_cols(prefix[:, :budget], budget, per_chunk)
        vals = torch.where(j[:budget] < torch.clamp(cnt, max=budget), head,
                           per_chunk)
        return vals[:, None, :], cnt

    def chunk_rows_multi(mask, ids, per_chunk, budget):
        """C > 1: one compaction per chunk over the masked id plane."""
        keepc = _round_up(min(budget, per_chunk), _ROW_ALIGN)
        vals_list, cnt_list = [], []
        for cix in range(C):
            in_c = mask & (ids >= cix * per_chunk) \
                & (ids < (cix + 1) * per_chunk)
            rel = torch.where(in_c, ids - cix * per_chunk, per_chunk)
            pref, cnt = compact_ascending_rows(rel, per_chunk, keepc)
            head = _pad_cols(pref[:, :budget], budget, per_chunk)
            vals_list.append(torch.where(
                j[:budget] < torch.clamp(cnt[:, None], max=budget), head,
                per_chunk))
            cnt_list.append(cnt)
        return torch.stack(vals_list, dim=1), torch.stack(cnt_list, dim=1)

    if C == 1:
        lvals, lcnt = chunk_rows(lprefix, lpc, k)
        gvals, gcnt = chunk_rows(gprefix, gpc, kg)
    else:
        lvals, lcnt = chunk_rows_multi(lhit, member, lpc, k)
        gvals, gcnt = chunk_rows_multi(_pad_cols(ghit, Gpad, False),
                                       _pad_cols(gids, Gpad, G), gpc, kg)

    # A truncated prefix (more survivors than K_l / K0 kept) makes the later
    # chunks' windows unreliable: those rows fall back to group mode or
    # raise overflow, conservatively.
    use_g = lcnt > k
    use_g = use_g | refine_truncated[:, None] | (ltotal > K_l)[:, None]
    overflow = torch.any(use_g & ((gcnt > kg) | (gtotal > K0)[:, None]))

    width = max(k, kg)
    cnt_col = torch.where(use_g, -torch.clamp(gcnt, max=kg),
                          torch.clamp(lcnt, max=k))
    body = torch.where(use_g[..., None], _pad_cols(gvals, width, gpc),
                       _pad_cols(lvals, width, lpc))
    rows = torch.cat([cnt_col[..., None], body], dim=2)
    rows = _pad_cols(rows, rowlen, lpc)
    return rows.permute(1, 0, 2).contiguous(), None, overflow


# ---------------------------------------------------------------------------
# Row compactor
# ---------------------------------------------------------------------------

def _check_compact_args(masked_ids: Tensor) -> None:
    if masked_ids.dim() != 2 or masked_ids.dtype != torch.int32:
        raise ValueError("masked_ids must be a (P, M) int32 tensor")


def compact_ascending_rows_plain(masked_ids: Tensor, sentinel: int,
                                 keep: int):
    """Plain PyTorch row compaction: the contract of ``compact_cuda``.

    masked_ids: (P, M) i32, masked-out entries == sentinel, survivors in
    ascending order. Returns (prefix (P, min(keep, M)) i32 holding the first
    survivors in order, sentinel-padded; counts (P,) i32 raw survivor
    counts, possibly > keep).
    """
    _check_compact_args(masked_ids)
    P, M = masked_ids.shape
    keep = min(keep, M)
    mask = masked_ids != sentinel
    counts = torch.sum(mask, dim=1, dtype=torch.int32)
    pos = torch.cumsum(mask, dim=1) - 1
    # Survivors past `keep` and masked entries land in a spare column.
    idx = torch.where(mask & (pos < keep), pos, keep)
    out = torch.full((P, keep + 1), sentinel, dtype=torch.int32,
                     device=masked_ids.device)
    out.scatter_(1, idx, masked_ids)
    return out[:, :keep].contiguous(), counts


def compact_cuda(masked_ids: Tensor, sentinel: int, keep: int):
    """Row compaction as the hand-written CUDA kernel (``csrc/compact.cu``).

    Same arguments and outputs as :func:`compact_ascending_rows_plain`.
    Raises for a tensor that is not on a CUDA device. Adds one to
    ``compact_cuda.launches`` per launch.
    """
    dev = _lib.require_cuda("compact_cuda", masked_ids)
    _check_compact_args(masked_ids)
    P, M = masked_ids.shape
    keep = min(keep, M)
    masked_ids = masked_ids.contiguous()
    out = torch.empty((P, keep), dtype=torch.int32, device=dev)
    counts = torch.empty((P,), dtype=torch.int32, device=dev)
    lib = _lib.load()
    with torch.cuda.device(dev):
        rc = lib.tracer_compact_rows(
            _lib.ptr(masked_ids), _lib.ptr(out), _lib.ptr(counts), P, M,
            keep, sentinel, _lib.stream(dev))
    _lib.check(lib, rc, "compact_cuda")
    compact_cuda.launches += 1
    return out, counts


compact_cuda.launches = 0


def compact_ascending_rows(masked_ids: Tensor, sentinel: int, keep: int):
    """Compact (P, M) rows of masked ascending ids; see
    :func:`compact_ascending_rows_plain`. CPU tensors run the plain version,
    anything else goes to :func:`compact_cuda`, which launches or raises."""
    if masked_ids.device.type == "cpu":
        return compact_ascending_rows_plain(masked_ids, sentinel, keep)
    return compact_cuda(masked_ids, sentinel, keep)


# ---------------------------------------------------------------------------
# The query
# ---------------------------------------------------------------------------

def kernel_order_dest(dest: Tensor, subpackets: int, subpacket: int) -> Tensor:
    """Map prep ``dest`` (padded-stream slots) to the leaf walk's raw output
    order: padded slot b = (g*S + s)*SP + r sits at g*SP*S + r*S + s."""
    S, SP = subpackets, subpacket
    g = dest // (S * SP)
    rem = dest - g * (S * SP)
    s = rem // SP
    r = rem - s * SP
    return g * (SP * S) + r * S + s


def nearest_hit_hybrid_feats(feats: Tensor, tables: ConeTables,
                             max_groups: int = 64,
                             max_candidates: int = 119):
    """Closest hit from prebuilt feature planes, in raw output order.

    feats: (G, S, SP, FEAT) from ``leafcull.prep_feats_bucketed``. Returns
    (t (G*SP*S,) f32, +inf on miss; slot (G*SP*S,) i32 prim slot, -1 on
    miss; overflow 0-d bool tensor). Index with ``kernel_order_dest`` for
    ray order and map slots with ``tables.cull.slot_to_sphere``.
    """
    cull = tables.cull
    g, S, SP, _ = feats.shape
    rows, _, overflow = cone_candidates(feats, tables, max_groups,
                                        max_candidates)
    rows = rows.reshape(cull.num_chunks, g, S, rows.shape[-1])
    t_k, slot = leafcull_call(feats, rows, cull.prims, cull.leaf_size,
                              cull.leaves_per_chunk, cull.leaves_per_group)
    slot = slot.reshape(-1)
    hit = slot < _NOSLOT
    t = torch.where(hit, t_k.reshape(-1),
                    torch.full_like(t_k.reshape(-1), float("inf")))
    return t, torch.where(hit, slot, torch.full_like(slot, -1)), overflow


def occluded_hybrid_feats(feats: Tensor, tables: ConeTables,
                          max_groups: int = 64, max_candidates: int = 119):
    """Any-hit (shadow) query from prebuilt feature planes, in raw order.

    feats must be packed with a finite t_max (``prep_feats_bucketed`` /
    ``pack_ray_features`` with ``t_max=``). Returns (occluded (G*SP*S,) i32,
    1 where a sphere blocks the segment (EPSILON, t_max); overflow 0-d bool
    tensor). Index with ``kernel_order_dest`` for ray order.
    """
    cull = tables.cull
    g, S, _, _ = feats.shape
    rows, _, overflow = cone_candidates(feats, tables, max_groups,
                                        max_candidates)
    rows = rows.reshape(cull.num_chunks, g, S, rows.shape[-1])
    occ = anyhit_call(feats, rows, cull.prims, cull.leaf_size,
                      cull.leaves_per_chunk, cull.leaves_per_group)
    return occ.reshape(-1), overflow


def nearest_hit_hybrid_raw(rays: Ray, tables: ConeTables,
                           max_groups: int = 64, max_candidates: int = 119,
                           subpackets: int = 8, subpacket: int = 128):
    """Closest hit for rays already in packet order (e.g. sorted and
    bucketed), in raw output order: ray i of the padded batch sits at
    ``kernel_order_dest(i)``. Same outputs as
    :func:`nearest_hit_hybrid_feats`."""
    o = rays.origin.reshape(-1, 3)
    d = rays.direction.reshape(-1, 3)
    feats, _, _ = pack_ray_features(o, d, subpackets, subpacket)
    return nearest_hit_hybrid_feats(feats, tables, max_groups,
                                    max_candidates)
