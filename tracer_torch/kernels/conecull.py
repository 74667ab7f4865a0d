"""Phase A of the queries, the row compactor, the phase-B cone-cull walk,
and the hybrid closest-hit and any-hit (shadow) queries.

PyTorch counterpart of ``tracer/kernels/conecull.py``. Phase A: per-subpacket
interval bounds from the feature planes, slab tests against group boxes and
then against the member leaves of surviving groups, and count-embedded
candidate rows per (subpacket, chunk) with a group-mode fallback and an
overflow flag. Rows, counts and overflow equal the JAX package's for the
same tables and features. The per-subpacket bounding cones that phase B
reads (``cone_from_feats``) match JAX's to rounding.

The compactor is ``compact_cuda`` (hand-written CUDA, ``csrc/compact.cu``)
on CUDA tensors and ``compact_ascending_rows_plain`` on CPU tensors;
:func:`compact_ascending_rows` picks by device and raises for any other.

Phase B (``conecull_call``: ``conecull_cuda``, ``csrc/conecull.cu``, on
CUDA tensors and ``conecull_plain`` on CPU tensors) walks the same rows as
the leaf walk but cone-tests every walked prim first and runs the u-form
quadratic only on the survivors. The cone test is conservative, so on the
same rows its (t, slot) equal ``leafcull_call``'s bit for bit. The kernel
walks the leaf walk's items (``csrc/leafwalk.cuh``): rows cut into items of
``CONE_ITEM_PRIMS`` prims, planned on the device by the launch; each
item's prims are cone-tested by the whole CTA, a row's survivors gathered
and tested by its rays, and each ray's best merged by the (-u, slot) key.
The JAX package evaluated phase B and ships the leaf walk; the port keeps
both.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import Tensor

from tracer_torch.bvh.flat import FlatBVH
from tracer_torch.core.types import Ray
from tracer_torch.intersect.brute import record_from_ids
from tracer_torch.intersect.sphere import EPSILON
from tracer_torch.kernels import _lib
from tracer_torch.kernels.leafcull import (CullTables, FEAT, anyhit_call,
                                           build_cull_tables, item_leaves,
                                           leafcull_call, pack_ray_features,
                                           ray_prim_u, _check_walk_args,
                                           _closest_t, _escalate,
                                           _merge_best, _min_merge_chunks,
                                           _sqrt_rn, _walk_pairs, _BIG,
                                           _NOSLOT)
from tracer_torch.scene.scene import Scene

# Row and prefix widths are rounded to this many ids exactly as in the JAX
# package, so that every row has the same length and padding on both sides.
_ROW_ALIGN = 128
CONE_FEAT = 16      # per-subpacket cone columns (11 used)
CONE_ITEM_PRIMS = 256   # prims per item of the phase-B walk (chip_smoke.py)
_SENTINEL_CCR = 1.0e29   # prims with |c|^2 - r^2 at or above this are slots
                         # that hold no sphere; the cone test drops them


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
    r_max = float(scene.radii.max()) if scene.radii.numel() else 0.0
    return ConeTables(cull=cull, leaf_boxes=leaf_box_rows(cull), r_max=r_max)


def leaf_box_rows(cull: CullTables) -> Tensor:
    """Attr-major member-leaf boxes per group, (Gc, lpg*6) f32:
    [lpg lox | loy | loz | hix | hiy | hiz]."""
    lpg = cull.leaves_per_group
    lo = cull.leaf_min.reshape(-1, lpg, 3)
    hi = cull.leaf_max.reshape(-1, lpg, 3)
    rows = torch.cat([lo[:, :, a] for a in range(3)]
                     + [hi[:, :, a] for a in range(3)], dim=1)
    return rows.contiguous()


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


def cone_from_feats(feats: Tensor, o_lo, o_hi, d_lo, d_hi, r_max: float,
                    slack: float = 0.05) -> Tensor:
    """Per-subpacket bounding cone, (P, CONE_FEAT) f32:
    [o0 xyz, u xyz, rho, cos, sin, rho^2, sin*rho, 0...].

    Apex o0 = origin-box centre; axis u = normalised direction-box
    midpoint; cos = min over the subpacket's rays of u.d/|d| (|d|^2 from
    feature column 10), less 1e-5; rho = r_max + origin-box half-diagonal +
    slack, the prim-level dilation. A subpacket whose cos is at most 0.05
    (its directions straddle the origin, e.g. unsorted rays) is degenerate:
    rho = 1e18 and the cone accepts every prim. The JAX version takes the
    min through an f32 matmul; here u.d is summed per ray, so the cones
    agree to rounding.
    """
    tiny = 1e-20
    o0 = 0.5 * (o_lo + o_hi)
    r_o = 0.5 * torch.sqrt(torch.sum((o_hi - o_lo) ** 2, dim=1))
    mid = 0.5 * (d_lo + d_hi)
    nrm = torch.sqrt(torch.sum(mid * mid, dim=1))
    u = mid / torch.clamp(nrm, min=tiny)[:, None]            # (P, 3)
    G, S = feats.shape[:2]
    uu = u.reshape(G, S, 1, 3)
    ud = feats[..., 0] * uu[..., 0] + feats[..., 1] * uu[..., 1] \
        + feats[..., 2] * uu[..., 2]                         # (G, S, SP)
    dn = torch.sqrt(torch.clamp(feats[..., 10], min=tiny))
    cos_exact = torch.amin(ud / dn, dim=2).reshape(-1) - 1e-5
    degenerate = (cos_exact <= 0.05) | (nrm <= tiny)
    cos = torch.clamp(cos_exact, 0.05, 1.0)
    sin = torch.sqrt(torch.clamp(1.0 - cos * cos, min=0.0))
    rho = torch.where(degenerate, torch.full_like(r_o, 1.0e18),
                      r_max + r_o + slack)
    cols = [o0[:, 0], o0[:, 1], o0[:, 2], u[:, 0], u[:, 1], u[:, 2], rho,
            cos, sin, rho * rho, sin * rho]
    cols += [torch.zeros_like(rho)] * (CONE_FEAT - len(cols))
    return torch.stack(cols, dim=1).to(torch.float32)


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
    output stands where the JAX function returns its cones; only the
    phase-B walk reads cones, and its path builds them with
    :func:`cone_from_feats`, so the leaf walk's phase A does not pay for
    them. No host sync.
    """
    cull = tables.cull
    k0 = _round_up(min(max_groups, cull.num_groups), 8)
    k = min(max_candidates, cull.leaves_per_chunk)
    rows, overflow = candidate_rows(bounds_from_feats(feats), cull,
                                    tables.leaf_boxes, k0, k,
                                    _round_up(k + 17, _ROW_ALIGN),
                                    exact=False)
    return rows, None, overflow


def candidate_rows(bounds, cull: CullTables, leaf_boxes: Tensor, k0: int,
                   k: int, rowlen: int, exact: bool):
    """The two levels of phase A, shared by :func:`cone_candidates` and
    ``leafcull.leaf_candidates``: (rows (C, P, rowlen) i32, overflow).

    bounds: per-subpacket (o_lo, o_hi, d_lo, d_hi), each (P, 3); leaf_boxes:
    attr-major member-leaf boxes per group (:func:`leaf_box_rows`). The
    first k0 surviving groups are refined to their member leaves; a row
    lists at most k leaves, else its groups (at most rowlen - 9). Both
    levels compact through :func:`compact_ascending_rows`, which keeps a
    prefix of each row's survivors and counts them all.

    With ``exact`` every count is the survivors' own, as a sort gives
    (``leaf_candidates``): the prefixes are kept wide enough for the row
    budgets. Without it (``cone_candidates``) a prefix of 512 ids decides,
    as the JAX cone phase A does: a row whose leaves overflow it falls back
    to group mode, and overflow is raised for a truncated group prefix.
    """
    o_lo, o_hi, d_lo, d_hi = bounds
    lpg = cull.leaves_per_group
    lpc = cull.leaves_per_chunk
    C = cull.num_chunks
    G = cull.num_groups
    dev = o_lo.device
    P = o_lo.shape[0]
    gpc = lpc // lpg
    kg = min(gpc, rowlen - 9)

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
    K0 = min(Gpad, max(_round_up(max(k0, kg) if exact else k0, _ROW_ALIGN),
                       4 * _ROW_ALIGN))
    gprefix, gtotal = compact_ascending_rows(gm_ids, G, K0)
    gcand = _pad_cols(gprefix[:, :k0], k0, G)

    # Refine: slab test against the member leaves of surviving groups.
    rows_lb = leaf_boxes[torch.clamp(gcand, max=G - 1).long()]
    att = [rows_lb[:, :, a * lpg:(a + 1) * lpg].reshape(P, -1)
           for a in range(6)]                            # 6 x (P, k0*lpg)
    member = (gcand[:, :, None] * lpg
              + torch.arange(lpg, dtype=torch.int32, device=dev)) \
        .reshape(P, -1)
    valid = member < cull.num_real_leaves
    lhit = _slab_hit_cols(o_lo, o_hi, d_lo, d_hi,
                          tuple(att[0:3]), tuple(att[3:6])) & valid
    refine_truncated = gtotal > k0

    j = torch.arange(max(k, kg), dtype=torch.int32, device=dev)

    def chunk_rows(prefix, total, per_chunk, budget):
        """C == 1: the chunk's row is a plain slice of the global prefix."""
        cnt = total if exact else \
            torch.sum(prefix < per_chunk, dim=1, dtype=torch.int32)
        cnt = cnt[:, None]
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

    use_g = refine_truncated[:, None]
    if C == 1 or not exact:
        K_l = min(member.shape[1],
                  max(_round_up(k, _ROW_ALIGN), 4 * _ROW_ALIGN) if exact
                  else 4 * _ROW_ALIGN)
        lprefix, ltotal = compact_ascending_rows(
            torch.where(lhit, member, C * lpc), C * lpc, K_l)
    if C == 1:
        lvals, lcnt = chunk_rows(lprefix, ltotal, lpc, k)
        gvals, gcnt = chunk_rows(gprefix, gtotal, gpc, kg)
    else:
        lvals, lcnt = chunk_rows_multi(lhit, member, lpc, k)
        gvals, gcnt = chunk_rows_multi(_pad_cols(ghit, Gpad, False),
                                       _pad_cols(gids, Gpad, G), gpc, kg)
    use_g = use_g | (lcnt > k)
    if exact:
        overflow = torch.any(use_g & (gcnt > kg))
    else:
        # A truncated prefix (more survivors than K_l / K0 kept) makes the
        # later chunks' windows unreliable: those rows fall back to group
        # mode or raise overflow, conservatively.
        use_g = use_g | (ltotal > K_l)[:, None]
        overflow = torch.any(use_g & ((gcnt > kg) | (gtotal > K0)[:, None]))

    width = max(k, kg)
    cnt_col = torch.where(use_g, -torch.clamp(gcnt, max=kg),
                          torch.clamp(lcnt, max=k))
    body = torch.where(use_g[..., None], _pad_cols(gvals, width, gpc),
                       _pad_cols(lvals, width, lpc))
    rows = torch.cat([cnt_col[..., None], body], dim=2)
    rows = _pad_cols(rows, rowlen, lpc)
    return rows.permute(1, 0, 2).contiguous(), overflow


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
# Phase B: the cone-cull walk
# ---------------------------------------------------------------------------

def _check_cones(feats: Tensor, cones: Tensor) -> None:
    G, S = feats.shape[:2]
    if tuple(cones.shape) != (G, S, CONE_FEAT) or cones.dtype != torch.float32:
        raise ValueError(f"cones must be ({G}, {S}, {CONE_FEAT}) float32, "
                         f"got {tuple(cones.shape)} {cones.dtype}")


def cone_keep(cone: Tensor, pr: Tensor) -> Tensor:
    """The per-prim cone test, rounded as the kernel rounds it: cone (n,
    CONE_FEAT) rows, pr (n, K, 4) prims (cx, cy, cz, |c|^2 - r^2) -> (n, K)
    bool. With v = c - o0 and q = |v|^2 - rho^2, a prim is kept when
    u.v + sin*rho >= cos*sqrt(max(q, 0)) or q <= 0, and never when it is a
    slot that holds no sphere (|c|^2 - r^2 >= 1e29)."""
    o0x, o0y, o0z, ux, uy, uz = (cone[:, k:k + 1] for k in range(6))
    cth, rho2, sinrho = cone[:, 7:8], cone[:, 9:10], cone[:, 10:11]
    vx = pr[..., 0] - o0x
    vy = pr[..., 1] - o0y
    vz = pr[..., 2] - o0z
    d2 = vx * vx + vy * vy + vz * vz
    uv = ux * vx + uy * vy + uz * vz
    q = d2 - rho2
    sq = _sqrt_rn(torch.clamp(q, min=0.0))
    return ((uv + sinrho >= cth * sq) | (q <= 0.0)) \
        & (pr[..., 3] < _SENTINEL_CCR)


@torch.no_grad()
def conecull_plain(feats: Tensor, cand: Tensor, cones: Tensor, prims: Tensor,
                   leaf_size: int, leaves_per_chunk: int,
                   leaves_per_group: int, pair_elems: int = 1 << 24):
    """Plain PyTorch phase-B walk: the contract of ``conecull_cuda``.

    feats (G, S, SP, FEAT) f32; cand (C, G, S, rowlen) i32 count-embedded
    rows as for ``leafcull_plain``; cones (G, S, CONE_FEAT) f32; prims
    (C, lpc*leaf_size, 4). Every prim of every walked leaf is cone-tested
    (:func:`cone_keep`; leaf ids at or past ``leaves_per_chunk`` hold no
    prim) and the survivors get the leaf walk's u-form test. Returns
    (t, slot), each (C, G, SP, S): the largest u below -eps*a, lowest
    global slot on ties, t = -u/a; (3e38, 2^30) where nothing hits; and
    kept (C, G, S) i32, the prims that survived the cone test per row.
    Pairs are tested in slices of at most ``pair_elems`` elements.
    """
    _check_walk_args(feats, cand, prims, leaf_size, leaves_per_chunk)
    _check_cones(feats, cones)
    G, S, SP, _ = feats.shape
    C, _, _, rowlen = cand.shape
    dev = feats.device
    ls = leaf_size
    Q = C * G * S
    rq = torch.arange(Q, device=dev)
    fidx, chunk = rq % (G * S), rq // (G * S)
    f = feats.reshape(G * S, SP, FEAT)
    cn = cones.reshape(G * S, CONE_FEAT)
    q_all, leaf_all = _walk_pairs(cand.reshape(Q, rowlen), leaves_per_group)
    inside = leaf_all < leaves_per_chunk
    q_all, leaf_all = q_all[inside], leaf_all[inside]
    kept = torch.zeros(Q, dtype=torch.int64, device=dev)
    best_u = torch.full((Q, SP), -_BIG, dtype=torch.float32, device=dev)
    best_slot = torch.full((Q, SP), _NOSLOT, dtype=torch.int64, device=dev)
    lane = torch.arange(ls, device=dev)
    step = max(1, pair_elems // (SP * ls))
    for i in range(0, q_all.shape[0], step):
        q = q_all[i:i + step]
        c = chunk[q]
        pslot = leaf_all[i:i + step, None] * ls + lane       # (n, ls)
        pr = prims[c[:, None], pslot]                        # (n, ls, 4)
        keep = cone_keep(cn[fidx[q]], pr)
        kept.index_add_(0, q, keep.sum(dim=1))
        pi, li = keep.nonzero(as_tuple=True)                 # survivors
        sq = q[pi]
        fb = f[fidx[sq]]                                     # (m, SP, FEAT)
        u, disc = ray_prim_u(fb, pr[pi, li][:, None, :])     # (m, SP, 1)
        ok = (disc > 0.0) & (u < -fb[:, :, 12:13])
        pu = torch.where(ok, u, torch.full_like(u, -_BIG))[:, :, 0]
        gslot = c[pi] * prims.shape[1] + pslot[pi, li]
        _merge_best(best_u, best_slot, sq, pu, gslot[:, None].expand(-1, SP))
    t, slot = _closest_t(best_u, best_slot, f[:, :, 11][fidx])
    return (t.reshape(C, G, S, SP).permute(0, 1, 3, 2).contiguous(),
            slot.reshape(C, G, S, SP).permute(0, 1, 3, 2).contiguous(),
            kept.reshape(C, G, S).to(torch.int32))


def conecull_cuda(feats: Tensor, cand: Tensor, cones: Tensor, prims: Tensor,
                  leaf_size: int, leaves_per_chunk: int,
                  leaves_per_group: int):
    """The phase-B walk as the hand-written CUDA kernel
    (``csrc/conecull.cu``): the items of ``leafcull_cuda``'s split walk,
    ``CONE_ITEM_PRIMS`` prims each, walked in runs of consecutive items;
    each item's prims are cone-tested by the whole CTA, and the rays test
    a row's survivors together.

    Same arguments and (t, slot, kept) outputs as :func:`conecull_plain`.
    Raises for tensors that are not on one CUDA device. Reads no device
    value on the host. Adds one to ``conecull_cuda.launches`` per launch.
    """
    _lib.require_cuda("conecull_cuda", feats, cand, cones, prims)
    _check_walk_args(feats, cand, prims, leaf_size, leaves_per_chunk)
    _check_cones(feats, cones)
    SP = feats.shape[2]
    if SP % 32 or not 32 <= SP <= 1024:
        raise ValueError(f"subpacket {SP} is not a whole number of warps "
                         f"in one CTA")
    return _conecull_launch(feats, cand, cones, prims, leaf_size,
                            leaves_per_chunk, leaves_per_group,
                            item_leaves(leaf_size, CONE_ITEM_PRIMS))


def _conecull_launch(feats: Tensor, cand: Tensor, cones: Tensor,
                     prims: Tensor, leaf_size: int, leaves_per_chunk: int,
                     leaves_per_group: int, chunk: int):
    """:func:`conecull_cuda` with items of ``chunk`` walked leaves."""
    dev = feats.device
    G, S, SP, _ = feats.shape
    C, _, _, rowlen = cand.shape
    feats, cand, cones, prims = (x.contiguous()
                                 for x in (feats, cand, cones, prims))
    # The launch plans the items (tilewalk.plan_items over walked_leaves)
    # and sets the keys and kept itself: torch ops for these took longer to
    # issue than the walk takes on the card.
    starts = torch.empty((C * G * S + 1,), dtype=torch.int32, device=dev)
    keys = torch.empty((C, G, S, SP), dtype=torch.int64, device=dev)
    t = torch.empty((C, G, SP, S), dtype=torch.float32, device=dev)
    slot = torch.empty((C, G, SP, S), dtype=torch.int32, device=dev)
    kept = torch.empty((C, G, S), dtype=torch.int32, device=dev)
    lib = _lib.load()
    with torch.cuda.device(dev):
        rc = lib.tracer_conecull(
            _lib.ptr(feats), _lib.ptr(cand), _lib.ptr(cones), _lib.ptr(prims),
            _lib.ptr(starts), _lib.ptr(keys), _lib.ptr(t), _lib.ptr(slot),
            _lib.ptr(kept), C, G, S, SP, rowlen, leaf_size, leaves_per_chunk,
            leaves_per_group, chunk, _lib.stream(dev))
    _lib.check(lib, rc, "conecull_cuda")
    conecull_cuda.launches += 1
    return t, slot, kept


conecull_cuda.launches = 0


def conecull_call(feats: Tensor, cand: Tensor, cones: Tensor, prims: Tensor,
                  leaf_size: int, leaves_per_chunk: int,
                  leaves_per_group: int):
    """Closest hit per ray through the phase-B walk: (t, slot), each
    (G, SP, S) as from ``leafcull_call`` (C > 1 chunks min-merged, lowest
    chunk on ties), and kept (C, G, S) i32, the cone-test survivors. CPU
    tensors run :func:`conecull_plain`; anything else goes to
    :func:`conecull_cuda`, which launches the kernel or raises."""
    walk = conecull_plain if feats.device.type == "cpu" else conecull_cuda
    t_c, slot_c, kept = walk(feats, cand, cones, prims, leaf_size,
                             leaves_per_chunk, leaves_per_group)
    return (*_min_merge_chunks(t_c, slot_c), kept)


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


@torch.no_grad()
def _ids_in_ray_order(rays: Ray, tables: ConeTables, max_groups: int,
                      max_candidates: int, subpackets: int, subpacket: int,
                      phase_b: bool):
    """Rays in packet order through phase A and a walk (the phase-B walk
    with ``phase_b``, else the leaf walk): (t (B,) f32, +inf on miss;
    sphere id (B,) i32, -1 on miss; overflow)."""
    cull = tables.cull
    o = rays.origin.reshape(-1, 3).detach()
    d = rays.direction.reshape(-1, 3).detach()
    b = o.shape[0]
    feats, g, _ = pack_ray_features(o, d, subpackets, subpacket)
    rows, _, overflow = cone_candidates(feats, tables, max_groups,
                                        max_candidates)
    rows = rows.reshape(cull.num_chunks, g, subpackets, rows.shape[-1])
    args = (cull.prims, cull.leaf_size, cull.leaves_per_chunk,
            cull.leaves_per_group)
    if phase_b:
        cones = cone_from_feats(feats, *bounds_from_feats(feats),
                                tables.r_max)
        t_k, slot, _ = conecull_call(
            feats, rows, cones.reshape(g, subpackets, CONE_FEAT), *args)
    else:
        t_k, slot = leafcull_call(feats, rows, *args)
    slot = slot.permute(0, 2, 1).reshape(-1)[:b]
    t_k = t_k.permute(0, 2, 1).reshape(-1)[:b]
    hit = slot < _NOSLOT
    sid = torch.where(hit, cull.slot_to_sphere[torch.where(
        hit, slot, 0).long()], torch.full_like(slot, -1))
    return (torch.where(hit, t_k, torch.full_like(t_k, float("inf"))), sid,
            overflow)


def nearest_hit_conecull_t(rays: Ray, tables: ConeTables,
                           max_groups: int = 64, max_candidates: int = 119,
                           subpackets: int = 8, subpacket: int = 128):
    """Closest hit through phase A with cones and the phase-B walk, for
    rays already in packet order (``core.sort.prep_rays_bucketed``): (t, +inf
    on miss; sphere id, -1 on miss; overflow 0-d bool tensor), t and ids in
    the rays' batch shape. On overflow re-dispatch with larger budgets."""
    t, sid, overflow = _ids_in_ray_order(rays, tables, max_groups,
                                         max_candidates, subpackets,
                                         subpacket, phase_b=True)
    return (t.reshape(rays.batch_shape), sid.reshape(rays.batch_shape),
            overflow)


def nearest_hit_hybrid_t(rays: Ray, tables: ConeTables, max_groups: int = 64,
                         max_candidates: int = 119, subpackets: int = 8,
                         subpacket: int = 128):
    """:func:`nearest_hit_conecull_t`'s contract through the leaf walk."""
    t, sid, overflow = _ids_in_ray_order(rays, tables, max_groups,
                                         max_candidates, subpackets,
                                         subpacket, phase_b=False)
    return (t.reshape(rays.batch_shape), sid.reshape(rays.batch_shape),
            overflow)


def nearest_hit_conecull(rays: Ray, scene: Scene, tables: ConeTables,
                         max_groups: int = 64, max_candidates: int = 119,
                         subpackets: int = 8, subpacket: int = 128):
    """Closest hit via the phase-B walk, for rays already in packet order;
    batch shape kept. Returns ``(HitRecord, overflow)``; t is recomputed from
    the winning sphere with the reference formulation, so autograd reaches
    the scene. On overflow re-dispatch with larger budgets
    (:func:`nearest_hit_conecull_checked` does)."""
    _, sid, overflow = _ids_in_ray_order(rays, tables, max_groups,
                                         max_candidates, subpackets,
                                         subpacket, phase_b=True)
    rec = record_from_ids(rays.origin.reshape(-1, 3),
                          rays.direction.reshape(-1, 3), sid, scene)
    return rec.reshape(rays.batch_shape), overflow


def nearest_hit_conecull_checked(rays: Ray, scene: Scene, tables: ConeTables,
                                 max_groups: int = 64,
                                 max_candidates: int = 119, **kw):
    """Escalating query over :func:`nearest_hit_conecull`: doubles both
    candidate budgets until no subpacket overflows. Returns (HitRecord,
    escalations)."""
    return _escalate(lambda k0, k: nearest_hit_conecull(
        rays, scene, tables, k0, k, **kw), tables, max_groups,
        max_candidates)
