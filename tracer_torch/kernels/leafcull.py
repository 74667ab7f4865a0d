"""Leaf-granular cull: tables, ray features and the closest-hit leaf walk.

PyTorch counterpart of ``tracer/kernels/leafcull.py`` for the closest-hit
query. A subpacket of SP direction-sorted rays gets a count-embedded row of
candidate leaves from phase A (``conecull.cone_candidates``); the leaf walk
tests each ray against every prim of those leaves and keeps the nearest hit.

The walk is ``leafcull_cuda`` (hand-written CUDA, ``csrc/leafcull.cu``) on
CUDA tensors and ``leafcull_plain`` (plain PyTorch, same contract) on CPU
tensors; :func:`leafcull_call` picks by device and raises for any other.

Number semantics follow the reference acceptance rule (disc > 0, near root
only, t > EPSILON; src/hit.c:19-39) in f32, in the kernels' u-form.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import Tensor

from tracer_torch.bvh.flat import FlatBVH
from tracer_torch.core.sort import octahedral_codes, plan_bucket_pad
from tracer_torch.intersect.sphere import EPSILON
from tracer_torch.kernels import _lib
from tracer_torch.scene.scene import Scene

_BIG = 3.0e38
_NOSLOT = 2 ** 30
FEAT = 16           # per-ray feature columns (14 used)
# The chunk budget is expressed in the JAX table's bytes per leaf pair
# (one 8 x 128 f32 block) so that leaves_per_chunk, and with it every
# candidate row, matches the JAX package for the same max_chunk_bytes.
_PAIR_BYTES = 8 * 128 * 4
_SENTINEL_CCR = 1.0e30


@dataclass
class CullTables:
    """Device tables for the leaf walk (build once per scene and BVH).

    prims:    (C, lpc*leaf_size, 4) f32, slot-major (cx, cy, cz, |c|^2-r^2)
              of chunk c's prim slots; sentinel slots hold (0, 0, 0, 1e30),
              which no ray can hit.
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
    ccr = c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1] + c[:, 2] * c[:, 2] - r * r
    prims = torch.stack([c[:, 0], c[:, 1], c[:, 2], ccr], dim=1)
    sentinel = torch.tensor([0.0, 0.0, 0.0, _SENTINEL_CCR],
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
    [dx, dy, dz, -2ox, -2oy, -2oz, 1, 0, o.d, |o|^2, a, 1/a, eps*a,
    -a*t_max (-3e38 without t_max), 0, 0]."""
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    zeros = torch.zeros_like(ox)
    ones = torch.ones_like(ox)
    od = ox * dx + oy * dy + oz * dz
    oo = ox * ox + oy * oy + oz * oz
    a = dx * dx + dy * dy + dz * dz
    inva = 1.0 / torch.clamp(a, min=1e-30)
    negat = (torch.full_like(a, -_BIG) if t_max is None
             else -a * t_max.reshape(-1))
    cols = [dx, dy, dz, -2.0 * ox, -2.0 * oy, -2.0 * oz, ones, zeros,
            od, oo, a, inva, EPSILON * a, negat]
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


def prep_feats_bucketed(o: Tensor, d: Tensor, subpackets: int,
                        subpacket: int, cell_bits: int = 8,
                        t_max: Tensor | None = None):
    """Sort + bucket-pad + feature pack, with the ray permutation applied
    once as a (bp, FEAT) row gather.

    Returns (feats (G, S, SP, FEAT), dest (B,) int64): dest maps each input
    ray to its slot in the padded stream (``conecull.kernel_order_dest``
    maps that to the leaf walk's raw output order).
    """
    step = subpackets * subpacket
    codes = octahedral_codes(d)
    sc, perm = torch.sort(codes, stable=True)
    src, dest_sorted = plan_bucket_pad(sc, subpacket, cell_bits=cell_bits)
    dest = torch.empty_like(dest_sorted)
    dest[perm] = dest_sorted
    feats = _feature_rows(o, d, t_max)[perm[src]]         # (bp, FEAT)
    feats = _pad_edge(feats, (-feats.shape[0]) % step)
    return feats.reshape(-1, subpackets, subpacket, FEAT), dest


# ---------------------------------------------------------------------------
# The leaf walk
# ---------------------------------------------------------------------------

def _check_walk_args(feats: Tensor, cand: Tensor, prims: Tensor,
                     leaf_size: int, leaves_per_chunk: int) -> None:
    G, S, SP, F = feats.shape
    C, Gc, Sc, _ = cand.shape
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

    Every (subpacket, leaf) pair is enumerated (a host sync sizes the list),
    tested in slices of ``pair_elems`` (pair, ray, prim) elements, and the
    per-pair bests are reduced per ray by max u, then min slot.
    """
    _check_walk_args(feats, cand, prims, leaf_size, leaves_per_chunk)
    G, S, SP, _ = feats.shape
    C, _, _, rowlen = cand.shape
    ls, lpc, lpg = leaf_size, leaves_per_chunk, leaves_per_group
    dev = feats.device
    Q = C * G * S

    rows = cand.reshape(Q, rowlen).long()
    nc = rows[:, 0]
    total = torch.where(nc > 0, nc, -nc * lpg)
    q = torch.repeat_interleave(torch.arange(Q, device=dev), total)
    n_pairs = q.shape[0]
    j = torch.arange(n_pairs, device=dev) - (torch.cumsum(total, 0)
                                             - total)[q]
    grp = nc[q] < 0
    entry = rows[q, torch.where(grp, 1 + j // lpg, 1 + j)]
    leaf = torch.where(grp, entry * lpg + j % lpg, entry)
    chunk = q // (G * S)
    fidx = q % (G * S)                                   # g * S + s
    f = feats.reshape(G * S, SP, FEAT)
    lane = torch.arange(ls, device=dev)

    pair_u = torch.empty((n_pairs, SP), dtype=torch.float32, device=dev)
    pair_slot = torch.empty((n_pairs, SP), dtype=torch.int64, device=dev)
    step = max(1, pair_elems // (SP * ls))
    for i in range(0, n_pairs, step):
        sl = slice(i, i + step)
        fb = f[fidx[sl]]                                 # (n, SP, FEAT)
        pslot = leaf[sl, None] * ls + lane               # (n, ls)
        pr = prims[chunk[sl, None], pslot]               # (n, ls, 4)
        cx, cy, cz, ccr = (pr[:, None, :, k] for k in range(4))
        dx, dy, dz = fb[:, :, 0:1], fb[:, :, 1:2], fb[:, :, 2:3]
        nox2, noy2, noz2 = fb[:, :, 3:4], fb[:, :, 4:5], fb[:, :, 5:6]
        od, oo, av, epsa = (fb[:, :, 8:9], fb[:, :, 9:10], fb[:, :, 10:11],
                            fb[:, :, 12:13])
        m1 = dx * cx + dy * cy + dz * cz                 # c.d
        m2 = nox2 * cx + noy2 * cy + noz2 * cz + ccr     # -2 o.c + ccr
        bp = od - m1                                     # oc.d
        cq = m2 + oo                                     # |oc|^2 - r^2
        disc = bp * bp - av * cq
        u = bp + _sqrt_rn(torch.clamp(disc, min=0.0))
        ok = (disc > 0.0) & (u < -epsa)
        uv = torch.where(ok, u, torch.full_like(u, -_BIG))
        ub, arg = torch.max(uv, dim=2)                   # first max: low slot
        gslot = chunk[sl, None] * (lpc * ls) + pslot     # (n, ls)
        pair_u[sl] = ub
        pair_slot[sl] = torch.where(ub > -_BIG, torch.gather(gslot, 1, arg),
                                    torch.full_like(arg, _NOSLOT))

    qi = q[:, None].expand(-1, SP)
    best_u = torch.full((Q, SP), -_BIG, dtype=torch.float32, device=dev)
    best_u.scatter_reduce_(0, qi, pair_u, "amax")
    cand_slot = torch.where(pair_u == best_u[q], pair_slot,
                            torch.full_like(pair_slot, _NOSLOT))
    best_slot = torch.full((Q, SP), _NOSLOT, dtype=torch.int64, device=dev)
    best_slot.scatter_reduce_(0, qi, cand_slot, "amin")

    inva = f[:, :, 11].repeat(C, 1)                      # (Q, SP)
    hit = best_slot < _NOSLOT
    t = torch.where(hit, -best_u * inva, torch.full_like(best_u, _BIG))
    t = t.reshape(C, G, S, SP).permute(0, 1, 3, 2).contiguous()
    slot = best_slot.to(torch.int32).reshape(C, G, S, SP) \
        .permute(0, 1, 3, 2).contiguous()
    return t, slot


def leafcull_cuda(feats: Tensor, cand: Tensor, prims: Tensor,
                  leaf_size: int, leaves_per_chunk: int,
                  leaves_per_group: int):
    """The leaf walk as the hand-written CUDA kernel (``csrc/leafcull.cu``).

    Same arguments and per-chunk (t, slot) outputs as :func:`leafcull_plain`.
    Raises for tensors that are not on one CUDA device. Adds one to
    ``leafcull_cuda.launches`` per launch.
    """
    dev = _lib.require_cuda("leafcull_cuda", feats, cand, prims)
    _check_walk_args(feats, cand, prims, leaf_size, leaves_per_chunk)
    G, S, SP, _ = feats.shape
    C, _, _, rowlen = cand.shape
    if not 1 <= SP <= 1024:
        raise ValueError(f"subpacket {SP} is not a valid CTA size")
    feats, cand, prims = (x.contiguous() for x in (feats, cand, prims))
    t = torch.empty((C, G, SP, S), dtype=torch.float32, device=dev)
    slot = torch.empty((C, G, SP, S), dtype=torch.int32, device=dev)
    lib = _lib.load()
    with torch.cuda.device(dev):
        rc = lib.tracer_leafcull(
            _lib.ptr(feats), _lib.ptr(cand), _lib.ptr(prims), _lib.ptr(t),
            _lib.ptr(slot), C, G, S, SP, rowlen, leaf_size,
            leaves_per_chunk, leaves_per_group, _lib.stream(dev))
    _lib.check(lib, rc, "leafcull_cuda")
    leafcull_cuda.launches += 1
    return t, slot


leafcull_cuda.launches = 0


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
    t_c, slot_c = walk(feats, cand, prims, leaf_size, leaves_per_chunk,
                       leaves_per_group)
    if t_c.shape[0] == 1:
        return t_c[0], slot_c[0]
    tm = torch.where(slot_c < _NOSLOT, t_c, torch.full_like(t_c, _BIG))
    ci = torch.argmin(tm, dim=0, keepdim=True)           # first minimum
    return (torch.gather(t_c, 0, ci)[0], torch.gather(slot_c, 0, ci)[0])
