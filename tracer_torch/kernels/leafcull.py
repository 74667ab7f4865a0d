"""Leaf-granular cull: tables, ray features and the leaf walks.

PyTorch counterpart of ``tracer/kernels/leafcull.py`` for the closest-hit
and any-hit (shadow) queries. A subpacket of SP direction-sorted rays gets
a count-embedded row of candidate leaves from phase A
(``conecull.cone_candidates``); the closest-hit walk tests each ray against
every prim of those leaves and keeps the nearest hit, the any-hit walk asks
whether any of them blocks the segment (EPSILON, t_max).

Each walk is a hand-written CUDA kernel on CUDA tensors (``leafcull_cuda``,
``csrc/leafcull.cu``; ``anyhit_cuda``, ``csrc/anyhit.cu``) and a plain
PyTorch version with the same contract on CPU tensors (``leafcull_plain``,
``anyhit_plain``); :func:`leafcull_call` and :func:`anyhit_call` pick by
device and raise for any other. Both kernels run one split walk
(``csrc/leafwalk.cuh``): each row's walked leaves are cut into items of
:func:`item_leaves` leaves, planned on the device
(``tilewalk.plan_items`` over :func:`walked_leaves`) and walked by a
persistent grid; the closest hit merges each ray's best by an
``atomicMin`` on the key (float bits of -u) << 32 | slot, the any hit ORs
its flags.

Prep (:func:`prep_feats_bucketed`: the octahedral sort, the cell bucket
padding and the feature rows) is hand-written CUDA and ``torch.sort`` on
CUDA tensors (``prep_cuda``, ``csrc/prep.cu``) and the torch operations on
CPU tensors (``prep_feats_plain``), bit for bit alike.

Number semantics follow the reference acceptance rule (disc > 0, near root
only, t > EPSILON; src/hit.c:19-39) in f32, on the reference's sums over
oc = o - c (:func:`ray_prim_u`), so rays from anywhere get its answers.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import Tensor

from tracer_torch import trace
from tracer_torch.bvh.flat import FlatBVH
from tracer_torch.core.sort import octahedral_codes, plan_bucket_pad
from tracer_torch.intersect.sphere import EPSILON
from tracer_torch.kernels import _lib, tilewalk
from tracer_torch.scene.scene import Scene

_BIG = 3.0e38
_NOSLOT = 2 ** 30
FEAT = 16           # per-ray feature columns (14 used)
# The chunk budget is expressed in the JAX table's bytes per leaf pair
# (one 8 x 128 f32 block) so that leaves_per_chunk, and with it every
# candidate row, matches the JAX package for the same max_chunk_bytes.
_PAIR_BYTES = 8 * 128 * 4
_SENTINEL_RSQ = -1.0e30   # the w of a slot that holds no sphere
# Prims per item of the split walks: the fastest of 128/256/512 in an
# on-card sweep of the leaf walks.
ITEM_PRIMS = 128
MISS_KEY = 2 ** 63 - 1   # the closest-hit walk's key of a ray with no hit


@dataclass
class CullTables:
    """Device tables for the leaf walk (build once per scene and BVH).

    prims:    (C, lpc*leaf_size, 4) f32, slot-major (cx, cy, cz, r^2)
              of chunk c's prim slots; sentinel slots hold (0, 0, 0, -1e30),
              which no ray can hit (|oc|^2 - w is 1e30).
    leaf_min/leaf_max: (L, 3) f32 leaf AABBs in slot order; padding leaves
              hold inverted boxes and are masked with ``num_real_leaves``.
    group_boxes: (Gc, lpg*8) f32 member-leaf boxes [lo3, hi3, 0, 0] per row.
    group_min/group_max: (Gc, 3) f32 boxes over ``leaves_per_group``
              consecutive leaves.
    slot_to_sphere: (L*leaf_size,) i32 prim slot -> sphere id (-1 pad).
    """

    prims: Tensor
    leaf_min: Tensor
    leaf_max: Tensor
    group_boxes: Tensor
    group_min: Tensor
    group_max: Tensor
    slot_to_sphere: Tensor
    leaf_size: int
    leaves_per_group: int
    leaves_per_chunk: int
    num_leaves: int
    num_real_leaves: int

    @property
    def num_chunks(self) -> int:
        return self.prims.shape[0]

    @property
    def num_groups(self) -> int:
        return self.group_min.shape[0]


def build_cull_tables(scene: Scene, bvh: FlatBVH,
                      leaves_per_group: int = 16,
                      max_chunk_bytes: int = 9 << 20) -> CullTables:
    """Build CullTables from a FlatBVH; tensors land on the scene's device.

    leaves_per_group and max_chunk_bytes keep the JAX defaults and chunking
    arithmetic, so the leaf boxes, group ids and chunk count equal the JAX
    tables' for the same arguments.
    """
    ls = bvh.leaf_size
    if not 1 <= ls <= 32:
        raise ValueError(f"leaf_size must be in [1, 32], got {ls}")
    lpg = leaves_per_group
    if lpg % 16:
        raise ValueError("leaves_per_group must be a multiple of 16")
    dev = scene.centers.device

    leaf_start = bvh.leaf_start.cpu().numpy()
    node_min = bvh.node_min.cpu().numpy()
    node_max = bvh.node_max.cpu().numpy()
    prim_idx = bvh.prim_idx.cpu().numpy()
    n = scene.centers.shape[0]
    is_leaf = leaf_start >= 0
    order = leaf_start[is_leaf] // ls
    leaf_is_real = prim_idx[leaf_start[is_leaf]] < n
    num_real = int(leaf_is_real.sum())
    if not (order[leaf_is_real] < num_real).all():
        raise ValueError("real leaves must occupy the first slots")
    node_min = np.where(np.isnan(node_min), _BIG, node_min)
    node_max = np.where(np.isnan(node_max), -_BIG, node_max)

    # Equal, group-aligned chunks (JAX leafcull.py:150-165).
    align = max(lpg, 2)
    cap = max((max_chunk_bytes // _PAIR_BYTES) * 2 - 2, align)
    n_chunks = max(1, -(-num_real // cap))
    if n_chunks > 1:
        cap2 = max((min(max_chunk_bytes, 12 << 19) // _PAIR_BYTES) * 2 - 2,
                   align)
        n_chunks = max(1, -(-num_real // cap2))
    lpc = -(-(-(-num_real // n_chunks)) // align) * align
    L = n_chunks * lpc

    lmin = np.full((L, 3), _BIG, np.float32)
    lmax = np.full((L, 3), -_BIG, np.float32)
    lmin[order[leaf_is_real]] = node_min[is_leaf][leaf_is_real]
    lmax[order[leaf_is_real]] = node_max[is_leaf][leaf_is_real]
    gmin = lmin.reshape(-1, lpg, 3).min(1)
    gmax = lmax.reshape(-1, lpg, 3).max(1)
    gboxes = np.zeros((L // lpg, lpg, 8), np.float32)
    gboxes[:, :, 0:3] = lmin.reshape(-1, lpg, 3)
    gboxes[:, :, 3:6] = lmax.reshape(-1, lpg, 3)
    gboxes = gboxes.reshape(L // lpg, lpg * 8)

    slots = np.full(L * ls, n, np.int64)
    take = min(prim_idx.shape[0], L * ls)
    slots[:take] = prim_idx[:take]

    sl = torch.as_tensor(slots, device=dev)
    real = sl < n
    safe = torch.clamp(sl, max=n - 1)
    c = scene.centers[safe]
    r = scene.radii[safe]
    prims = torch.stack([c[:, 0], c[:, 1], c[:, 2], r * r], dim=1)
    sentinel = torch.tensor([0.0, 0.0, 0.0, _SENTINEL_RSQ],
                            dtype=torch.float32, device=dev)
    prims = torch.where(real[:, None], prims, sentinel)

    def t(a):
        return torch.as_tensor(a, device=dev)

    return CullTables(
        prims=prims.reshape(n_chunks, lpc * ls, 4).contiguous(),
        leaf_min=t(lmin), leaf_max=t(lmax), group_boxes=t(gboxes),
        group_min=t(gmin), group_max=t(gmax),
        slot_to_sphere=t(np.where(slots == n, -1, slots).astype(np.int32)),
        leaf_size=ls, leaves_per_group=lpg, leaves_per_chunk=lpc,
        num_leaves=L, num_real_leaves=num_real)


# ---------------------------------------------------------------------------
# Ray features and prep
# ---------------------------------------------------------------------------

def _feature_rows(o: Tensor, d: Tensor, t_max: Tensor | None = None) -> Tensor:
    """(B, 3) rays -> (B, FEAT) f32 feature rows:
    [dx, dy, dz, ox, oy, oz, 1, 0, 0, 0, a, 1/a, eps*a,
    -a*t_max (-3e38 without t_max), 0, 0]."""
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    zeros = torch.zeros_like(ox)
    ones = torch.ones_like(ox)
    a = dx * dx + dy * dy + dz * dz
    inva = 1.0 / torch.clamp(a, min=1e-30)
    negat = (torch.full_like(a, -_BIG) if t_max is None
             else -a * t_max.reshape(-1))
    cols = [dx, dy, dz, ox, oy, oz, ones, zeros, zeros, zeros, a, inva,
            EPSILON * a, negat]
    cols += [zeros] * (FEAT - len(cols))
    return torch.stack(cols, dim=-1).to(torch.float32)


def _pad_edge(x: Tensor, pad: int) -> Tensor:
    """Append ``pad`` copies of the last row."""
    if pad == 0:
        return x
    return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])


def pack_ray_features(o: Tensor, d: Tensor, subpackets: int, subpacket: int,
                      t_max: Tensor | None = None):
    """(B, 3) rays in order -> ((G, S, SP, FEAT) features, G, pad). Padding
    rays replicate the last real ray."""
    step = subpackets * subpacket
    b = o.shape[0]
    g = -(-b // step)
    pad = g * step - b
    if t_max is not None:
        t_max = _pad_edge(t_max.reshape(-1), pad)
    feats = _feature_rows(_pad_edge(o, pad), _pad_edge(d, pad), t_max)
    return feats.reshape(g, subpackets, subpacket, FEAT), g, pad


def prep_feats_plain(o: Tensor, d: Tensor, subpackets: int,
                     subpacket: int, cell_bits: int = 8,
                     t_max: Tensor | None = None):
    """:func:`prep_feats_bucketed` as torch operations: the octahedral
    codes, a stable sort, ``plan_bucket_pad``, the feature rows gathered
    through the ray permutation once as a (bp, FEAT) row gather, padded to
    the step with the last row, and dest scattered through the
    permutation. What CPU tensors run, and the kernels' yardstick."""
    step = subpackets * subpacket
    codes = octahedral_codes(d)
    sc, perm = torch.sort(codes, stable=True)
    src, dest_sorted = plan_bucket_pad(sc, subpacket, cell_bits=cell_bits)
    dest = torch.empty_like(dest_sorted)
    dest[perm] = dest_sorted
    feats = _feature_rows(o, d, t_max)[perm[src]]         # (bp, FEAT)
    feats = _pad_edge(feats, (-feats.shape[0]) % step)
    return feats.reshape(-1, subpackets, subpacket, FEAT), dest


PREP_MAX_CELL_BITS = 12   # the cell table of csrc/prep.cu: 48 KB of ints


def _check_prep_args(o: Tensor, d: Tensor, subpackets: int, subpacket: int,
                     cell_bits: int, t_max: Tensor | None) -> None:
    b = o.shape[0]
    if o.dim() != 2 or tuple(d.shape) != (b, 3) or o.shape[1] != 3 \
            or o.dtype != torch.float32 or d.dtype != torch.float32:
        raise ValueError(f"o and d must be (B, 3) float32, got "
                         f"{tuple(o.shape)} {o.dtype}, {tuple(d.shape)} "
                         f"{d.dtype}")
    if t_max is not None and (t_max.numel() != b
                              or t_max.dtype != torch.float32):
        raise ValueError(f"t_max must hold {b} float32 values, got "
                         f"{tuple(t_max.shape)} {t_max.dtype}")
    if not 0 <= cell_bits <= PREP_MAX_CELL_BITS:
        raise ValueError(f"cell_bits {cell_bits} outside 0.."
                         f"{PREP_MAX_CELL_BITS}")
    if b < 1 or subpackets < 1 or subpacket < 1:
        raise ValueError(f"{b} rays in subpackets {subpackets} x "
                         f"{subpacket}")
    step = subpackets * subpacket
    if -(-(b + (subpacket << cell_bits)) // step) * step >= 2 ** 31:
        raise ValueError(f"{b} rays pad past 2^31 slots")


def prep_cuda(o: Tensor, d: Tensor, subpackets: int, subpacket: int,
              cell_bits: int = 8, t_max: Tensor | None = None):
    """:func:`prep_feats_bucketed` as hand-written CUDA (``csrc/prep.cu``)
    and ``torch.sort``: each ray's octahedral code as an int32 key with its
    sign bit flipped (one launch), the stable sort of the keys, the cell
    table of the bucket padding (one block), and one pass over the padded
    slots that writes every feature row and dest. Three launches besides
    the sort's; nothing over the slots is planned in device memory.
    Returns (feats, dest), bit for bit :func:`prep_feats_plain`'s. Raises
    for tensors that are not on one CUDA device, and for arguments the
    kernels do not take."""
    _check_prep_args(o, d, subpackets, subpacket, cell_bits, t_max)
    dev = _lib.require_cuda("prep_cuda", o, d,
                            *(() if t_max is None else (t_max,)))
    b = o.shape[0]
    step = subpackets * subpacket
    bp = b + (subpacket << cell_bits)
    total = -(-bp // step) * step
    o, d = o.contiguous(), d.contiguous()
    tm = None if t_max is None else t_max.reshape(-1).contiguous()
    keys = torch.empty(b, dtype=torch.int32, device=dev)
    _lib.launch("prep_cuda", "tracer_prep_keys", dev, d, keys, b)
    sorted_keys, perm = torch.sort(keys, stable=True)
    cells = torch.empty((3, 1 << cell_bits), dtype=torch.int32, device=dev)
    _lib.launch("prep_cuda", "tracer_prep_cells", dev, sorted_keys, cells, b,
                subpacket, cell_bits)
    feats = torch.empty((total // step, subpackets, subpacket, FEAT),
                        dtype=torch.float32, device=dev)
    dest = torch.empty(b, dtype=torch.int64, device=dev)
    _lib.launch("prep_cuda", "tracer_prep_rows", dev, o, d, tm, sorted_keys,
                perm, cells, feats, dest, b, total, bp, cell_bits)
    return feats, dest


@trace.spanned("prep")
def prep_feats_bucketed(o: Tensor, d: Tensor, subpackets: int,
                        subpacket: int, cell_bits: int = 8,
                        t_max: Tensor | None = None):
    """Sort + bucket-pad + feature pack of (B, 3) rays.

    Returns (feats (G, S, SP, FEAT), dest (B,) int64): dest maps each input
    ray to its slot in the padded stream (``conecull.kernel_order_dest``
    maps that to the leaf walk's raw output order). CUDA tensors take
    :func:`prep_cuda`, CPU tensors :func:`prep_feats_plain`; the trace
    counts which ran as ``prep_kernel`` (1 the kernels, 0 the torch
    operations).
    """
    kernel = o.device.type != "cpu"
    prep = prep_cuda if kernel else prep_feats_plain
    feats, dest = prep(o, d, subpackets, subpacket, cell_bits, t_max)
    trace.count(prep_kernel=int(kernel))
    return feats, dest


# ---------------------------------------------------------------------------
# Phase A over padded rays (the differentiable path's candidates)
# ---------------------------------------------------------------------------

def subpacket_bounds(o: Tensor, d: Tensor, subpacket: int):
    """(B, 3) padded rays -> per-subpacket interval bounds (o_lo, o_hi,
    d_lo, d_hi), each (P, 3)."""
    ot = o.reshape(-1, subpacket, 3)
    dt = d.reshape(-1, subpacket, 3)
    return ot.amin(1), ot.amax(1), dt.amin(1), dt.amax(1)


def leaf_candidate_rows(o: Tensor, d: Tensor, tables: CullTables,
                        max_groups: int, max_candidates: int,
                        subpacket: int):
    """Hierarchical phase A on padded, direction-sorted rays; the body of
    :func:`leaf_candidates`, for callers that open the span themselves.

    o/d: (P*subpacket, 3). Returns (rows (C, P, rowlen) i32 per-chunk
    count-embedded relative leaf ids, overflow 0-d bool tensor), in
    ``conecull.cone_candidates``' row format: k0 = min(max_groups, G)
    groups are refined, a row lists at most k = min(max_candidates, lpc)
    leaves, else its groups, and rowlen is k + 17 rounded up to 128. Every
    count is exact, so rows and overflow equal the JAX function's. Both
    levels compact through ``conecull.compact_ascending_rows`` (the CUDA
    compactor on CUDA tensors) where the JAX function sorts. No host sync.
    """
    from tracer_torch.kernels.conecull import (candidate_rows, count_rows,
                                               leaf_box_rows, _round_up,
                                               _ROW_ALIGN)
    k = min(max_candidates, tables.leaves_per_chunk)
    rows, overflow = candidate_rows(subpacket_bounds(o, d, subpacket), tables,
                                    leaf_box_rows(tables),
                                    min(max_groups, tables.num_groups), k,
                                    _round_up(k + 17, _ROW_ALIGN), exact=True)
    trace.count(phase_a_kernel=0)
    count_rows(rows)
    return rows, overflow


@trace.spanned("phase_a")
def leaf_candidates(o: Tensor, d: Tensor, tables: CullTables,
                    max_groups: int, max_candidates: int, subpacket: int):
    """:func:`leaf_candidate_rows` as the span ``tracer_torch.phase_a``."""
    return leaf_candidate_rows(o, d, tables, max_groups, max_candidates,
                               subpacket)


# ---------------------------------------------------------------------------
# The leaf walk
# ---------------------------------------------------------------------------

def check_slot_space(num_chunks: int, leaves_per_chunk: int,
                     leaf_size: int) -> None:
    """Raise ValueError unless every padded prim slot of a table of
    ``num_chunks`` chunks of ``leaves_per_chunk`` leaves lies below
    ``_NOSLOT``: the walks compute slots in int32, keep them in the low 32
    bits of their merge keys and read 2^30 as "no slot"."""
    slots = num_chunks * leaves_per_chunk * leaf_size
    if slots >= _NOSLOT:
        raise ValueError(f"{num_chunks} chunks x {leaves_per_chunk} leaves "
                         f"x {leaf_size} prims = {slots} slots reach the "
                         f"no-slot sentinel 2^30")


def _check_walk_args(feats: Tensor, cand: Tensor, prims: Tensor,
                     leaf_size: int, leaves_per_chunk: int) -> None:
    G, S, SP, F = feats.shape
    C, Gc, Sc, _ = cand.shape
    check_slot_space(prims.shape[0], leaves_per_chunk, leaf_size)
    if F != FEAT or (Gc, Sc) != (G, S):
        raise ValueError(f"feats {tuple(feats.shape)} and rows "
                         f"{tuple(cand.shape)} disagree")
    if tuple(prims.shape) != (C, leaves_per_chunk * leaf_size, 4):
        raise ValueError(f"prims {tuple(prims.shape)} does not match "
                         f"{C} chunks of {leaves_per_chunk} leaves")
    if feats.dtype != torch.float32 or prims.dtype != torch.float32 \
            or cand.dtype != torch.int32:
        raise ValueError("feats/prims must be float32 and rows int32")


def _sqrt_rn(x: Tensor) -> Tensor:
    """Correctly rounded f32 sqrt, as CUDA's sqrtf in the kernel gives.

    torch's vectorised CPU sqrt is not: about 0.6 % of f32 results are an
    ulp off, and which elements take the vector path depends on how the
    work is split across threads, so results would vary from run to run.
    Through float64 the rounding back to f32 is exact.
    """
    return torch.sqrt(x.double()).float()


def _walk_pairs(rows: Tensor, leaves_per_group: int):
    """Every (row, leaf) pair a walk visits, in walk order.

    rows (Q, rowlen) count-embedded (count > 0: leaf ids; count < 0:
    -count group ids whose member leaves are all walked; 0: nothing).
    Returns (q, leaf), each (n,) int64: the row and its relative leaf id.
    A host sync sizes the list.
    """
    lpg = leaves_per_group
    rows = rows.long()
    nc = rows[:, 0]
    total = torch.where(nc > 0, nc, -nc * lpg)
    q = torch.repeat_interleave(torch.arange(rows.shape[0],
                                             device=rows.device), total)
    j = torch.arange(q.shape[0], device=rows.device) \
        - (torch.cumsum(total, 0) - total)[q]
    grp = nc[q] < 0
    entry = rows[q, torch.where(grp, 1 + j // lpg, 1 + j)]
    return q, torch.where(grp, entry * lpg + j % lpg, entry)


def _pair_slices(f: Tensor, fidx: Tensor, chunk: Tensor, rows: Tensor,
                 prims: Tensor, leaf_size: int, leaves_per_group: int,
                 pair_elems: int):
    """The (ray, prim) tests of every walked pair, in slices.

    f (R, SP, FEAT) feature rows; rows (Q, rowlen) candidate rows, row q
    walking chunk ``chunk[q]`` for feature row ``fidx[q]``. Yields
    (q, fb, u, disc, gslot) per slice of at most ``pair_elems`` (pair, ray,
    prim) elements: q (n,), fb (n, SP, FEAT), u and disc (n, SP, ls) in
    the kernels' rounding, gslot (n, ls) global prim slots.
    """
    ls = leaf_size
    SP = f.shape[1]
    spc = prims.shape[1]
    q_all, leaf_all = _walk_pairs(rows, leaves_per_group)
    lane = torch.arange(ls, device=f.device)
    step = max(1, pair_elems // (SP * ls))
    for i in range(0, q_all.shape[0], step):
        q = q_all[i:i + step]
        c = chunk[q]
        fb = f[fidx[q]]                                  # (n, SP, FEAT)
        pslot = leaf_all[i:i + step, None] * ls + lane   # (n, ls)
        pr = prims[c[:, None], pslot]                    # (n, ls, 4)
        u, disc = ray_prim_u(fb, pr)
        yield q, fb, u, disc, c[:, None] * spc + pslot


def ray_prim_u(fb: Tensor, pr: Tensor):
    """The test of every ray against every prim, as the kernels round it
    (``walk::ray_prim_disc``): fb (n, R, FEAT) feature rows, pr (n, K, 4)
    prims (cx, cy, cz, r^2). The reference's sums on oc = o - c, halved:
    b' = oc.d, cq = |oc|^2 - r^2, disc = b'^2 - a*cq. Returns (u, disc),
    each (n, R, K): u = b' + sqrt(max(disc, 0)), t = -u/a on the near
    root."""
    cx, cy, cz, rsq = (pr[:, None, :, k] for k in range(4))
    dx, dy, dz = fb[:, :, 0:1], fb[:, :, 1:2], fb[:, :, 2:3]
    ox, oy, oz, av = fb[:, :, 3:4], fb[:, :, 4:5], fb[:, :, 5:6], \
        fb[:, :, 10:11]
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    bp = ocx * dx + ocy * dy + ocz * dz                  # oc.d
    cq = ocx * ocx + ocy * ocy + ocz * ocz - rsq         # |oc|^2 - r^2
    disc = bp * bp - av * cq
    return bp + _sqrt_rn(torch.clamp(disc, min=0.0)), disc


def closest_rows_plain(f: Tensor, fidx: Tensor, chunk: Tensor, rows: Tensor,
                       prims: Tensor, leaf_size: int, leaves_per_group: int,
                       pair_elems: int = 1 << 24):
    """The closest-hit walk of every row (see :func:`_pair_slices`):
    (t, slot), each (Q, SP): the largest u (smallest t = -u/a) over the
    walked prims, lowest global slot on ties; (3e38, 2^30) where nothing
    hits."""
    return _closest_t(*closest_rows_u(f, fidx, chunk, rows, prims, leaf_size,
                                      leaves_per_group, pair_elems),
                      f[:, :, 11][fidx])


def closest_rows_u(f: Tensor, fidx: Tensor, chunk: Tensor, rows: Tensor,
                   prims: Tensor, leaf_size: int, leaves_per_group: int,
                   pair_elems: int = 1 << 24):
    """:func:`closest_rows_plain` before t: (u f32, slot int64), each
    (Q, SP), -3e38 and 2^30 where nothing hits. Per slice, each pair's best
    is merged into the rows' bests by max u, then min slot among equal
    u."""
    Q, SP = rows.shape[0], f.shape[1]
    dev = f.device
    best_u = torch.full((Q, SP), -_BIG, dtype=torch.float32, device=dev)
    best_slot = torch.full((Q, SP), _NOSLOT, dtype=torch.int64, device=dev)
    for q, fb, u, disc, gslot in _pair_slices(
            f, fidx, chunk, rows, prims, leaf_size, leaves_per_group,
            pair_elems):
        ok = (disc > 0.0) & (u < -fb[:, :, 12:13])
        uv = torch.where(ok, u, torch.full_like(u, -_BIG))
        pu, arg = torch.max(uv, dim=2)                   # first max: low slot
        _merge_best(best_u, best_slot, q, pu, torch.gather(gslot, 1, arg))
    return best_u, best_slot


def _merge_best(best_u: Tensor, best_slot: Tensor, q: Tensor, pu: Tensor,
                pslot: Tensor) -> None:
    """Merge candidates into the rows' bests in place: rows q (n,), u values
    pu (n, SP) (-3e38 for none) with their slots pslot (n, SP). Largest u
    wins, then the lowest slot among equal u, whatever the order."""
    pslot = torch.where(pu > -_BIG, pslot, torch.full_like(pslot, _NOSLOT))
    qi = q[:, None].expand(-1, pu.shape[1])
    before = best_u.clone()
    best_u.scatter_reduce_(0, qi, pu, "amax")
    best_slot.masked_fill_(best_u > before, _NOSLOT)     # a better u came
    cand = torch.where(pu == best_u[q], pslot, torch.full_like(pslot, _NOSLOT))
    best_slot.scatter_reduce_(0, qi, cand, "amin")


def _closest_t(best_u: Tensor, best_slot: Tensor, inva: Tensor):
    """(t, slot i32) from the bests: t = -u/a where a slot won, else 3e38."""
    hit = best_slot < _NOSLOT
    t = torch.where(hit, -best_u * inva, torch.full_like(best_u, _BIG))
    return t, best_slot.to(torch.int32)


def leafcull_plain(feats: Tensor, cand: Tensor, prims: Tensor,
                   leaf_size: int, leaves_per_chunk: int,
                   leaves_per_group: int, pair_elems: int = 1 << 24):
    """Plain PyTorch leaf walk: the contract of ``leafcull_cuda``.

    feats (G, S, SP, FEAT) f32; cand (C, G, S, rowlen) i32 count-embedded
    rows (count > 0: relative leaf ids; count < 0: -count relative group
    ids whose member leaves are all walked; 0: nothing); prims
    (C, lpc*leaf_size, 4). Returns per-chunk (t, slot), each (C, G, SP, S):
    the largest u (smallest t) over the walked prims, lowest global slot on
    ties; (3e38, 2^30) where nothing hits.

    Every (subpacket, leaf) pair is enumerated (a host sync sizes the list)
    and tested in slices of ``pair_elems`` (pair, ray, prim) elements.
    """
    _check_walk_args(feats, cand, prims, leaf_size, leaves_per_chunk)
    G, S, SP, _ = feats.shape
    C, _, _, rowlen = cand.shape
    q = torch.arange(C * G * S, device=feats.device)
    t, slot = closest_rows_plain(
        feats.reshape(G * S, SP, FEAT), q % (G * S), q // (G * S),
        cand.reshape(-1, rowlen), prims, leaf_size, leaves_per_group,
        pair_elems)
    return (t.reshape(C, G, S, SP).permute(0, 1, 3, 2).contiguous(),
            slot.reshape(C, G, S, SP).permute(0, 1, 3, 2).contiguous())


def leafcull_cuda(feats: Tensor, cand: Tensor, prims: Tensor,
                  leaf_size: int, leaves_per_chunk: int,
                  leaves_per_group: int):
    """The leaf walk as the hand-written CUDA kernel (``csrc/leafcull.cu``):
    rows split into items of :func:`item_leaves` leaves on a persistent
    grid, merged per ray by a packed (-u, slot) key.

    Same arguments and per-chunk (t, slot) outputs as :func:`leafcull_plain`.
    Raises for tensors that are not on one CUDA device. Reads no device
    value on the host.
    """
    dev = _lib.require_cuda("leafcull_cuda", feats, cand, prims)
    _check_walk_args(feats, cand, prims, leaf_size, leaves_per_chunk)
    G, S, SP, _ = _walk_shape(feats)
    C, _, _, rowlen = cand.shape
    chunk = item_leaves(leaf_size)
    feats, cand, prims = (x.contiguous() for x in (feats, cand, prims))
    starts = tilewalk.plan_items(walked_leaves(cand, leaves_per_group), chunk)
    keys = torch.full((C, G, S, SP), MISS_KEY, dtype=torch.int64, device=dev)
    t = torch.empty((C, G, SP, S), dtype=torch.float32, device=dev)
    slot = torch.empty((C, G, SP, S), dtype=torch.int32, device=dev)
    _lib.launch("leafcull_cuda", "tracer_leafcull", dev, feats, cand, prims,
                starts, keys, t, slot, C, G, S, SP, rowlen, leaf_size,
                leaves_per_chunk, leaves_per_group, chunk)
    return t, slot


def _walk_shape(feats: Tensor):
    """feats' shape (G, S, SP, FEAT); raises unless SP rays fit a CTA."""
    SP = feats.shape[2]
    if not 1 <= SP <= 1024:
        raise ValueError(f"subpacket {SP} is not a valid CTA size")
    return feats.shape


def walked_leaves(cand: Tensor, leaves_per_group: int) -> Tensor:
    """(C * G * S,) int32 leaves each count-embedded row of ``cand`` walks:
    count in leaf mode, -count * leaves_per_group in group mode. Stays on
    the device."""
    nc = cand.reshape(-1, cand.shape[-1])[:, 0]
    return torch.where(nc > 0, nc, nc * -leaves_per_group)


def item_leaves(leaf_size: int, prims: int = ITEM_PRIMS) -> int:
    """W, the walked leaves of one item of the split walks: ``prims``
    prims' worth, at least one leaf."""
    return max(1, prims // leaf_size)


@trace.spanned("walk")
def leafcull_call(feats: Tensor, cand: Tensor, prims: Tensor,
                  leaf_size: int, leaves_per_chunk: int,
                  leaves_per_group: int):
    """Closest hit per ray over its subpacket's candidate rows: (t, slot),
    each (G, SP, S), ray g*S*SP + s*SP + r at [g, r, s].

    CPU tensors run :func:`leafcull_plain`; anything else goes to
    :func:`leafcull_cuda`, which launches the kernel or raises. With C > 1
    chunks the per-chunk results are min-merged by t, lowest chunk first on
    ties (chunks ascend in slot order, so the lowest slot still wins).
    """
    walk = leafcull_plain if feats.device.type == "cpu" else leafcull_cuda
    return _min_merge_chunks(*walk(feats, cand, prims, leaf_size,
                                   leaves_per_chunk, leaves_per_group))


def _min_merge_chunks(t_c: Tensor, slot_c: Tensor):
    """Per-chunk (t, slot) (C, ...) -> the smallest t over chunks, the
    lowest chunk on ties (chunks ascend in slot order)."""
    if t_c.shape[0] == 1:
        return t_c[0], slot_c[0]
    tm = torch.where(slot_c < _NOSLOT, t_c, torch.full_like(t_c, _BIG))
    ci = torch.argmin(tm, dim=0, keepdim=True)           # first minimum
    return (torch.gather(t_c, 0, ci)[0], torch.gather(slot_c, 0, ci)[0])


# ---------------------------------------------------------------------------
# The any-hit (shadow) walk
# ---------------------------------------------------------------------------

def anyhit_pairs(feats: Tensor, cand: Tensor, prims: Tensor, leaf_size: int,
                 leaves_per_chunk: int, leaves_per_group: int,
                 pair_elems: int = 1 << 24):
    """Occlusion by each walked (row, leaf) pair: (q (n,) int64 rows of the
    flattened (C, G, S) row grid, in walk order; occ (n, SP) bool). A pair
    occludes a ray when one of its prims gives disc > 0, u < -eps*a and
    u > -a*t_max (feature column 13)."""
    _check_walk_args(feats, cand, prims, leaf_size, leaves_per_chunk)
    G, S, SP, _ = feats.shape
    C, _, _, rowlen = cand.shape
    rq = torch.arange(C * G * S, device=feats.device)
    qs, occs = [], []
    for q, fb, u, disc, _ in _pair_slices(
            feats.reshape(G * S, SP, FEAT), rq % (G * S), rq // (G * S),
            cand.reshape(-1, rowlen), prims, leaf_size, leaves_per_group,
            pair_elems):
        ok = (disc > 0.0) & (u < -fb[:, :, 12:13]) & (u > fb[:, :, 13:14])
        qs.append(q)
        occs.append(ok.any(dim=2))
    if not qs:
        return (torch.zeros(0, dtype=torch.int64, device=feats.device),
                torch.zeros((0, SP), dtype=torch.bool, device=feats.device))
    return torch.cat(qs), torch.cat(occs)


def anyhit_plain(feats: Tensor, cand: Tensor, prims: Tensor, leaf_size: int,
                 leaves_per_chunk: int, leaves_per_group: int,
                 pair_elems: int = 1 << 24) -> Tensor:
    """Plain PyTorch any-hit walk: the contract of ``anyhit_cuda``.

    feats (G, S, SP, FEAT) f32 packed with a finite t_max; cand
    (C, G, S, rowlen) i32 count-embedded rows as for :func:`leafcull_plain`;
    prims (C, lpc*leaf_size, 4). Returns occ (G, SP, S) i32: 1 where any
    walked prim of any chunk occludes the ray (see :func:`anyhit_pairs`).
    It walks every listed leaf: the kernel's early exit changes no flag.
    """
    G, S, SP, _ = feats.shape
    C = cand.shape[0]
    q, occ = anyhit_pairs(feats, cand, prims, leaf_size, leaves_per_chunk,
                          leaves_per_group, pair_elems)
    rows = torch.zeros((C * G * S, SP), dtype=torch.int32,
                       device=feats.device)
    rows.index_put_((q,), occ.to(torch.int32), accumulate=True)
    occ_rows = (rows > 0).reshape(C, G, S, SP).any(dim=0)   # OR over chunks
    return occ_rows.permute(0, 2, 1).to(torch.int32).contiguous()


def anyhit_cuda(feats: Tensor, cand: Tensor, prims: Tensor, leaf_size: int,
                leaves_per_chunk: int, leaves_per_group: int) -> Tensor:
    """The any-hit walk as the hand-written CUDA kernel (``csrc/anyhit.cu``):
    the split walk of :func:`leafcull_cuda`, its flags ORed by plain stores.

    Same arguments and (G, SP, S) i32 output as :func:`anyhit_plain`.
    Raises for tensors that are not on one CUDA device. Reads no device
    value on the host.
    """
    dev = _lib.require_cuda("anyhit_cuda", feats, cand, prims)
    _check_walk_args(feats, cand, prims, leaf_size, leaves_per_chunk)
    G, S, SP, _ = _walk_shape(feats)
    C, _, _, rowlen = cand.shape
    chunk = item_leaves(leaf_size)
    feats, cand, prims = (x.contiguous() for x in (feats, cand, prims))
    starts = tilewalk.plan_items(walked_leaves(cand, leaves_per_group), chunk)
    occ = torch.zeros((G, SP, S), dtype=torch.int32, device=dev)
    _lib.launch("anyhit_cuda", "tracer_anyhit", dev, feats, cand, prims,
                starts, occ, C, G, S, SP, rowlen, leaf_size,
                leaves_per_chunk, leaves_per_group, chunk)
    return occ


@trace.spanned("walk")
def anyhit_call(feats: Tensor, cand: Tensor, prims: Tensor, leaf_size: int,
                leaves_per_chunk: int, leaves_per_group: int) -> Tensor:
    """Occlusion per ray over its subpacket's candidate rows, ORed over
    chunks: (G, SP, S) i32, ray g*S*SP + s*SP + r at [g, r, s]. CPU tensors
    run :func:`anyhit_plain`; anything else goes to :func:`anyhit_cuda`,
    which launches the kernel or raises."""
    walk = anyhit_plain if feats.device.type == "cpu" else anyhit_cuda
    return walk(feats, cand, prims, leaf_size, leaves_per_chunk,
                leaves_per_group)


# ---------------------------------------------------------------------------
# HitRecord and occlusion queries over rays in caller order
# ---------------------------------------------------------------------------

def _escalate(query, rays: int, budgets: tuple, grow,
              kind: str = "closest"):
    """Run ``query(*budgets) -> (result, overflow)`` over ``rays`` rays,
    growing the budgets by ``grow(budgets)`` until nothing overflows or
    ``grow`` gives None (they cover the whole table; one host sync per
    try); each retry is the span ``tracer_torch.escalate``, its argument
    the escalation's number, its counter ``escalated_rays`` the call's
    rays, all of which the retry takes again (known from the shapes, no
    sync). Counts the call in ``trace.checked(kind, ...)``. Returns
    (result, escalations).

    The leaf walks' checked drivers pass phase A alone as ``query``
    (:func:`_phase_a_query`): a retry reruns phase A, and no ray is walked
    again. So does the checked soft evaluation
    (``diff.sparse.soft_loss_grad_sparse``, kind "soft"), whose composite
    runs once at the budgets that hold. The tile, packet and phase-B
    drivers pass their whole call."""
    escalations = 0
    out, overflow = query(*budgets)
    while bool(overflow):
        budgets = grow(budgets)
        if budgets is None:
            break
        escalations += 1
        with trace.span("escalate", escalations):
            trace.count(escalated_rays=rays)
            out, overflow = query(*budgets)
    trace.checked(kind, escalations)
    return out, escalations


def _doubled_budgets(tables):
    """The leaf walks' growth rule for :func:`_escalate` over ``tables``
    (``ConeTables``): :func:`_doubled_cull_budgets` of their cull
    tables."""
    return _doubled_cull_budgets(tables.cull)


def _doubled_cull_budgets(cull: CullTables):
    """A growth rule for :func:`_escalate` over single-chunk or chunked
    ``cull`` tables: (max_groups, max_candidates) both doubled, each up to
    what covers the table (its groups, a chunk's leaves); None once both
    do."""
    G, lpc = cull.num_groups, cull.leaves_per_chunk

    def grow(budgets):
        k0, k = budgets
        if k0 >= G and k >= lpc:
            return None
        return min(2 * k0, G), min(2 * k, lpc)
    return grow


def _phase_a_query(feats: Tensor, tables):
    """:func:`_escalate`'s query for the leaf walks' checked drivers:
    phase A alone (``conecull.cone_candidates``) over the prepped
    ``feats`` at budgets (k0, k) -> (rows, overflow)."""
    from tracer_torch.kernels.conecull import cone_candidates

    def phase_a(k0: int, k: int):
        rows, _, overflow = cone_candidates(feats, tables, k0, k)
        return rows, overflow
    return phase_a


def _hit_record(o: Tensor, d: Tensor, slot: Tensor, dest: Tensor,
                scene: Scene, tables, subpackets: int, subpacket: int):
    """The closest hit's epilogue: raw-order slots to ray order
    (``kernel_order_dest`` over prep's ``dest``), slot to sphere, and t
    recomputed from the sphere with the reference formulation
    (``record_from_ids``), so autograd reaches the scene. (B,) records."""
    from tracer_torch.intersect.brute import record_from_ids
    from tracer_torch.kernels.conecull import kernel_order_dest
    with torch.no_grad():
        slot = slot[kernel_order_dest(dest, subpackets, subpacket)]
        idx = torch.where(slot >= 0, tables.cull.slot_to_sphere[
            torch.clamp(slot, min=0).long()], torch.full_like(slot, -1))
    return record_from_ids(o, d, idx, scene)


def nearest_hit_leafcull(rays, scene: Scene, tables, max_groups: int = 48,
                         max_candidates: int = 119, subpackets: int = 8,
                         subpacket: int = 64, cell_bits: int = 8):
    """Closest hit via prep, phase A and the leaf walk; batch shape kept.

    ``tables`` are ``conecull.ConeTables``. The rays are sorted and
    bucketed (``prep_feats_bucketed``), phase A is ``cone_candidates`` and
    the walk ``leafcull_call`` (through ``nearest_hit_hybrid_feats``); the
    winning slot maps to its sphere and t is recomputed from it with the
    reference formulation, so autograd reaches the scene. Returns
    ``(HitRecord, overflow)``; on overflow re-dispatch with larger budgets
    (:func:`nearest_hit_leafcull_checked` does).
    """
    from tracer_torch.kernels.conecull import nearest_hit_hybrid_feats
    o = rays.origin.reshape(-1, 3)
    d = rays.direction.reshape(-1, 3)
    with torch.no_grad():
        feats, dest = prep_feats_bucketed(o.detach(), d.detach(), subpackets,
                                          subpacket, cell_bits=cell_bits)
        _, slot, overflow = nearest_hit_hybrid_feats(
            feats, tables, max_groups, max_candidates)
    rec = _hit_record(o, d, slot, dest, scene, tables, subpackets, subpacket)
    return rec.reshape(rays.batch_shape), overflow


@trace.spanned("nearest")
def nearest_hit_leafcull_checked(rays, scene: Scene, tables,
                                 max_groups: int = 48,
                                 max_candidates: int = 119,
                                 subpackets: int = 8, subpacket: int = 64,
                                 cell_bits: int = 8):
    """:func:`nearest_hit_leafcull` with escalation: prep once, then phase
    A at both candidate budgets doubled (:func:`_escalate`) until no
    subpacket overflows, then one leaf walk over the last try's rows and
    the epilogue. A retry reruns phase A alone and walks no ray again; the
    result equals bit for bit :func:`nearest_hit_leafcull`'s at the
    budgets the ladder ends on. Returns (HitRecord, escalations)."""
    from tracer_torch.kernels.conecull import closest_from_rows
    o = rays.origin.reshape(-1, 3)
    d = rays.direction.reshape(-1, 3)
    n = o.shape[0]
    trace.count_outermost(rays=n)
    with torch.no_grad():
        feats, dest = prep_feats_bucketed(o.detach(), d.detach(), subpackets,
                                          subpacket, cell_bits=cell_bits)
        rows, escalations = _escalate(
            _phase_a_query(feats, tables), n, (max_groups, max_candidates),
            _doubled_budgets(tables))
        _, slot = closest_from_rows(feats, rows, tables.cull)
    rec = _hit_record(o, d, slot, dest, scene, tables, subpackets, subpacket)
    return rec.reshape(rays.batch_shape), escalations


@torch.no_grad()
def nearest_hit_leafcull_t(rays, tables: CullTables, max_groups: int = 48,
                           max_candidates: int = 119, subpackets: int = 8,
                           subpacket: int = 64):
    """Lite closest hit: (t, sphere id, overflow) straight from the leaf
    walk, without the HitRecord epilogue (no point, normal or t recomputed
    from the winning sphere); t is the walk's own (-u/a, :func:`ray_prim_u`),
    +inf on a miss, the id -1. Batch shape kept.

    The rays go in the caller's order, packed into subpackets as they come
    (``pack_ray_features``), so sort them first (``core.sort``); phase A is
    :func:`leaf_candidates` over ``tables`` (CullTables) and the walk
    :func:`leafcull_call`. On overflow re-dispatch with larger budgets.
    """
    batch_shape = rays.batch_shape
    o = rays.origin.reshape(-1, 3).detach()
    d = rays.direction.reshape(-1, 3).detach()
    b = o.shape[0]
    feats, g, pad = pack_ray_features(o, d, subpackets, subpacket)
    rows, overflow = leaf_candidates(_pad_edge(o, pad), _pad_edge(d, pad),
                                     tables, max_groups, max_candidates,
                                     subpacket)
    rows = rows.reshape(tables.num_chunks, g, subpackets, rows.shape[-1])
    t_k, slot = leafcull_call(feats, rows, tables.prims, tables.leaf_size,
                              tables.leaves_per_chunk,
                              tables.leaves_per_group)
    # (G, SP, S): ray g*S*SP + s*SP + r sits at [g, r, s].
    slot = slot.permute(0, 2, 1).reshape(-1)[:b]
    t_k = t_k.permute(0, 2, 1).reshape(-1)[:b]
    hit = slot < _NOSLOT
    sid = torch.where(hit, tables.slot_to_sphere[torch.where(
        hit, slot, 0).long()], torch.full_like(slot, -1))
    t = torch.where(hit, t_k, torch.full_like(t_k, float("inf")))
    return t.reshape(batch_shape), sid.reshape(batch_shape), overflow


def occluded_leafcull(rays, tables, t_max, max_groups: int = 48,
                      max_candidates: int = 119, subpackets: int = 8,
                      subpacket: int = 64, cell_bits: int = 8):
    """Shadow query: (occluded (batch,) bool, overflow). True where a
    sphere blocks the segment (EPSILON, t_max) of the ray, t in units of
    the ray's own (possibly unnormalised) direction; ``t_max`` is a scalar
    or one value per ray. Prep, ``cone_candidates`` and the any-hit walk
    (through ``conecull.occluded_hybrid_feats``)."""
    from tracer_torch.kernels.conecull import (kernel_order_dest,
                                               occluded_hybrid_feats)
    with torch.no_grad():
        feats, dest = _shadow_prep(rays, t_max, subpackets, subpacket,
                                   cell_bits)
        occ, overflow = occluded_hybrid_feats(feats, tables, max_groups,
                                              max_candidates)
        occ = occ[kernel_order_dest(dest, subpackets, subpacket)] > 0
    return occ.reshape(rays.batch_shape), overflow


def _shadow_prep(rays, t_max, subpackets: int, subpacket: int,
                 cell_bits: int):
    """Prep of shadow rays: ``t_max`` (a scalar or one value per ray) as
    each ray's (B,) f32 segment end, then :func:`prep_feats_bucketed`."""
    o = rays.origin.reshape(-1, 3).detach()
    d = rays.direction.reshape(-1, 3).detach()
    tm = torch.as_tensor(t_max, dtype=torch.float32, device=o.device)
    tm = tm.reshape(-1).expand(o.shape[0]).contiguous()
    return prep_feats_bucketed(o, d, subpackets, subpacket,
                               cell_bits=cell_bits, t_max=tm)


@trace.spanned("occluded")
def occluded_leafcull_checked(rays, tables, t_max, max_groups: int = 48,
                              max_candidates: int = 119,
                              subpackets: int = 8, subpacket: int = 64,
                              cell_bits: int = 8):
    """:func:`occluded_leafcull` with escalation: prep once, phase A at
    doubling budgets until no subpacket overflows (a retry reruns phase A
    alone and walks no ray again), then one any-hit walk over the last
    try's rows. Equals bit for bit :func:`occluded_leafcull` at the
    budgets the ladder ends on. Returns (occluded, escalations)."""
    from tracer_torch.kernels.conecull import (kernel_order_dest,
                                               occluded_from_rows)
    n = rays.origin.numel() // 3
    trace.count_outermost(rays=n)
    with torch.no_grad():
        feats, dest = _shadow_prep(rays, t_max, subpackets, subpacket,
                                   cell_bits)
        rows, escalations = _escalate(
            _phase_a_query(feats, tables), n, (max_groups, max_candidates),
            _doubled_budgets(tables), kind="shadow")
        occ = occluded_from_rows(feats, rows, tables.cull)
        occ = occ[kernel_order_dest(dest, subpackets, subpacket)] > 0
    return occ.reshape(rays.batch_shape), escalations
