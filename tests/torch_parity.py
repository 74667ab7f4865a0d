"""Shared inputs and converters for the PyTorch-port parity tests.

Both packages take the same seeded numpy arrays: the JAX scene factories
draw from ``jax.random``, which torch cannot reproduce, so scenes, BVHs and
rays are made once here and handed to each side. The JAX side runs on the
CPU as its own tests do (Pallas kernels in interpret mode); the port runs
its plain PyTorch versions on CPU tensors.

Where the JAX function copies a fault of f32 arithmetic that the port
repairs (the soft model's perp2 cancels), the reference is the JAX function
run in float64 (:func:`x64`, :func:`f64`, :func:`scene64`,
:func:`camera64`) on the same f32-valued inputs.

The port's walks test rays on oc = o - c, as the reference does, where the
JAX package expands |o|^2 - 2 o.c + (|c|^2 - r^2): its feature rows hold
-2o, o.d and |o|^2 and its prims |c|^2 - r^2, the port's o and r^2.
:func:`jax_feats` and :func:`jax_prims` turn the port's into the JAX
package's, rounded as both packages rounded them before (so a JAX walk
gets what it always got), and :func:`port_feats` turns JAX feature rows
back. From the world's origin both tests take the same sums.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tracer_torch as tt
from tracer.bvh.builder import build_bvh as jax_build_bvh
from tracer.scene.scene import Scene as JScene
from tracer.scene.scene import fixed_scene

S, SP, CELL_BITS = 4, 64, 4      # small packets for CPU-sized tests


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one CPU thread for a test module: small tensor indexing on
    many threads costs milliseconds per op, and far more when other test
    processes share the cores; the plain walks and the blocked phase A
    index every slice. A module turns it on by importing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_(x) -> np.ndarray:
    """A writable numpy copy of a JAX array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    return np.array(x)


def to_torch(x) -> torch.Tensor:
    return torch.as_tensor(np_(x))


def to_jax(x):
    return jnp.asarray(np_(x))


def jax_feats(feats) -> torch.Tensor:
    """The port's ray feature rows (..., 16) in the JAX package's layout:
    columns 3-5 -2o, 8 o.d and 9 |o|^2 in place of o, 0, 0."""
    f = to_torch(feats).clone()
    o, d = f[..., 3:6].clone(), f[..., 0:3]
    f[..., 3:6] = -2.0 * o
    f[..., 8] = o[..., 0] * d[..., 0] + o[..., 1] * d[..., 1] \
        + o[..., 2] * d[..., 2]
    f[..., 9] = o[..., 0] * o[..., 0] + o[..., 1] * o[..., 1] \
        + o[..., 2] * o[..., 2]
    return f


def jfeats(feats):
    """:func:`jax_feats` as a JAX array, for the JAX walks."""
    return to_jax(jax_feats(feats))


def port_feats(feats) -> torch.Tensor:
    """JAX feature rows (..., 16) in the port's layout: o from -2o (exact),
    columns 8 and 9 zero."""
    f = to_torch(feats).clone()
    f[..., 3:6] = f[..., 3:6] * -0.5
    f[..., 8:10] = 0.0
    return f


def jax_prims(prims) -> torch.Tensor:
    """The port's prims (..., 4) (cx, cy, cz, r^2) as the JAX package's
    (cx, cy, cz, |c|^2 - r^2); the port's sentinel r^2 = -1e30 becomes the
    JAX sentinel 1e30."""
    p = to_torch(prims).clone()
    p[..., 3] = p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1] \
        + p[..., 2] * p[..., 2] - p[..., 3]
    return p


def scene_np(n: int, seed: int = 3, world: float = 60.0,
             radius: float = 0.5):
    """(centers, radii, albedo) of the benchmark distribution: n spheres of
    one radius uniform in a centered cube of side ``world``."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-world / 2, world / 2, (n, 3)).astype(np.float32)
    r = np.full(n, radius, np.float32)
    a = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return c, r, a


def origin_rays_np(b: int, seed: int = 0):
    """(origins, unit directions) of b origin rays, uniform-cube dirs."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(-1, 1, (b, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.zeros_like(d), d


DUP = (128 + 5, 3 * 128 + 9)    # slots of one sphere stored in tiles 1, 3


def tie_tiles_np(num_tiles: int, b: int, seed: int):
    """Spheres filling ``num_tiles`` 128-slot tiles, one of them stored
    twice (slots ``DUP``, an exact t tie for every ray), and b rays, a third
    of them from near that sphere aimed at it: (centres (n, 3), radii (n,),
    origins (b, 3), unit directions (b, 3)), float32."""
    rng = np.random.default_rng(seed)
    n = num_tiles * 128
    c = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    r = rng.uniform(0.5, 2.0, n).astype(np.float32)
    c[DUP[1]], r[DUP[0]] = c[DUP[0]], 3.0
    r[DUP[1]] = r[DUP[0]]
    o = rng.uniform(-30, 30, (b, 3)).astype(np.float32)
    aim = c[rng.integers(0, n, b)]
    near = np.arange(b) % 3 == 0
    off = rng.normal(size=(b, 3))
    off /= np.linalg.norm(off, axis=1, keepdims=True)
    o[near] = c[DUP[0]] + 8.0 * off[near]
    aim[near] = c[DUP[0]]
    d = aim - o + rng.normal(0, 0.2, (b, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return c, r, o, d.astype(np.float32)


def leaf_dup(leaf_size: int):
    """The chunk-0 slots of :func:`tie_leaves`' sphere that is stored
    twice: slot 2 of leaf 1 and slot 1 of leaf 5."""
    return (1 * leaf_size + 2, 5 * leaf_size + 1)


LEAF_DUP = leaf_dup(4)


def tie_leaves(seed: int, t_max=None, leaf_size: int = 4,
               bundles: bool = False):
    """A two-chunk leaf table (16 leaves of ``leaf_size`` per chunk, groups
    of 4 leaves) of 32 * leaf_size spheres, one stored twice in chunk 0
    (slots ``leaf_dup(leaf_size)``: an exact u tie for every ray that hits
    it), 2 x 2 subpackets of 64 rays, a third of them aimed at that sphere,
    and rows of every kind: empty, leaf mode (the two copies listed high
    leaf first, every leaf descending, a run) and group mode (every group,
    two groups out of order, one). With ``bundles``, subpackets 0 and 2
    are instead narrow bundles from two points 10 units off that sphere
    aimed at it, subpacket 3 one aimed at another sphere, and subpacket 1
    keeps the scattered rays: the first three get tight bounding cones, the
    last a degenerate one. Returns (feats (2, 2, 64, FEAT), cand
    (2, 2, 2, 17) int32, prims (2, 16 * leaf_size, 4), leaf_size,
    leaves_per_chunk, leaves_per_group)."""
    ls, lpc, lpg = leaf_size, 16, 4
    dup = leaf_dup(ls)
    rng = np.random.default_rng(seed)
    c = rng.uniform(-20, 20, (2 * lpc * ls, 3)).astype(np.float32)
    r = rng.uniform(0.5, 2.0, 2 * lpc * ls).astype(np.float32)
    c[dup[1]], r[dup[0]] = c[dup[0]], 3.0
    r[dup[1]] = r[dup[0]]
    b = 256
    o = rng.uniform(-30, 30, (b, 3)).astype(np.float32)
    aim = c[rng.integers(0, len(c), b)]
    near = np.arange(b) % 3 == 0
    off = rng.normal(size=(b, 3))
    off /= np.linalg.norm(off, axis=1, keepdims=True)
    o[near] = c[dup[0]] + 8.0 * off[near]
    aim[near] = c[dup[0]]
    d = aim - o + rng.normal(0, 0.2, (b, 3))
    if bundles:
        for k, target in ((0, c[dup[0]]), (2, c[dup[0]]), (3, c[7])):
            sub = slice(64 * k, 64 * (k + 1))
            way = rng.normal(size=3)
            o[sub] = target + 10.0 * way / np.linalg.norm(way) \
                + rng.uniform(-0.5, 0.5, (64, 3))
            d[sub] = target - o[sub] + rng.normal(0, 0.5, (64, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    ct, rt = torch.as_tensor(c), torch.as_tensor(r)
    prims = torch.cat([ct, (rt * rt)[:, None]], 1).reshape(2, lpc * ls, 4)
    tm = None if t_max is None else torch.full((b,), float(t_max))
    feats, _, _ = tt.pack_ray_features(torch.as_tensor(o), torch.as_tensor(d),
                                       2, 64, t_max=tm)
    lists = [[], [5, 1], [-4, 0, 1, 2, 3], list(range(15, -1, -1)),
             [-2, 3, 0], list(range(8)), [], [-1, 1]]
    cand = torch.full((8, 17), lpc, dtype=torch.int32)
    for i, row in enumerate(lists):
        count = row[0] if row and row[0] < 0 else len(row)
        ids = row[1:] if count < 0 else row
        cand[i, 0] = count
        cand[i, 1:1 + len(ids)] = torch.tensor(ids, dtype=torch.int32)
    return feats, cand.reshape(2, 2, 2, 17), prims, ls, lpc, lpg


def prims_to_entries(prims, leaf_size: int):
    """The port's slot-major (C, lpc*leaf_size, 4) prim table -> JAX
    pair-packed, lane-replicated entries (C, lpc/2 + 1, 8, 128) with the
    sentinel entry last: the inverse of :func:`entries_to_prims` over
    :func:`jax_prims`."""
    p = np_(jax_prims(prims))
    C, n = p.shape[:2]
    E = n // (2 * leaf_size)
    e = p.reshape(C, E, 2, leaf_size, 4).transpose(0, 1, 2, 4, 3) \
        .reshape(C, E, 8, leaf_size)
    e = np.tile(e, (1, 1, 1, 128 // leaf_size))
    sentinel = np.zeros((C, 1, 8, 128), np.float32)
    sentinel[:, :, 3] = sentinel[:, :, 7] = 1.0e30
    return jnp.asarray(np.concatenate([e, sentinel], axis=1))


BATCH_IDS = 1024   # ids a warp of compact_cuda loads before it ranks them


def compact_warp_model(masked_ids, sentinel: int, keep: int):
    """``compact_cuda`` (csrc/compact.cu) batch by batch: each row's ids in
    batches of BATCH_IDS, a batch in 32-lane slices (V consecutive ids a
    lane: 4 where M % 4 == 0, else 2 where M is even, else 1; the kernel
    takes those widths where the rows are aligned for them, as torch's
    allocations are), an id's rank = the survivors in lower
    lanes of its slice plus its lane's earlier survivors, stored at
    carry + rank while that is below keep; once the carry reaches keep the
    rest of the row is only counted; then the sentinel tail. Returns
    (prefix (P, min(keep, M)) int32, counts (P,) int32)."""
    ids = torch.as_tensor(np_(masked_ids))
    P, M = ids.shape
    keep = min(keep, M)
    V = 4 if M % 4 == 0 else 2 if M % 2 == 0 else 1
    out = torch.full((P, keep), sentinel, dtype=torch.int32)
    carry = torch.zeros(P, dtype=torch.int64)
    rows = torch.arange(P)[:, None, None].expand(P, 32, V)
    for base in range(0, M, BATCH_IDS):
        batch = ids[:, base:base + BATCH_IDS]
        n = batch.shape[1]
        width = -(-n // (32 * V)) * 32 * V
        batch = torch.cat([batch, torch.full((P, width - n), sentinel,
                                             dtype=torch.int32)], 1)
        for sl in batch.reshape(P, -1, 32, V).unbind(1):    # (P, 32, V)
            flag = sl != sentinel
            lanes = flag.sum(2)
            before = (torch.cumsum(lanes, 1) - lanes)[:, :, None] \
                + torch.cumsum(flag, 2) - flag.long()
            pos = carry[:, None, None] + before
            store = flag & (pos < keep) & (carry < keep)[:, None, None]
            out[rows[store], pos[store]] = sl[store]
            carry += lanes.sum(1)
    return out, carry.to(torch.int32)


def _slab_lanes(b, lo, hi) -> np.ndarray:
    """csrc/phase_a.cu's slab_hit for one row's bounds b (12,) against the
    boxes of a step's lanes, lo/hi (3, n) f32: an IEEE reciprocal, each
    product rounded, NaN-propagating min/max (np.minimum, np.maximum)."""
    f32 = np.float32
    tnear = tfar = None
    with np.errstate(all="ignore"):
        for a in range(3):
            ol, oh, dl, dh = (f32(b[i + a]) for i in (0, 3, 6, 9))
            free = bool(dl <= 0) and bool(dh >= 0)
            ilo = f32(1) / (f32(1) if free else dh)
            ihi = f32(1) / (f32(1) if free else dl)

            def imul(al, ah):
                p = [al * ilo, al * ihi, ah * ilo, ah * ihi]
                return (np.minimum(np.minimum(p[0], p[1]),
                                   np.minimum(p[2], p[3])),
                        np.maximum(np.maximum(p[0], p[1]),
                                   np.maximum(p[2], p[3])))

            t1l, t1h = imul(lo[a] - oh, lo[a] - ol)
            t2l, t2h = imul(hi[a] - oh, hi[a] - ol)
            tn = np.full_like(t1l, f32(-1e18)) if free else np.minimum(t1l,
                                                                       t2l)
            tf = np.full_like(t1h, f32(1e18)) if free else np.maximum(t1h,
                                                                      t2h)
            tnear = tn if tnear is None else np.maximum(tnear, tn)
            tfar = tf if tfar is None else np.minimum(tfar, tf)
        return (tfar >= tnear) & (tfar > f32(1e-6))


def phase_a_row_model(bounds, tables, S: int, k0: int, k: int, kg: int,
                      keep_l: int, gkeep: int, rowlen: int, pair_c=None,
                      pair_gb=None, pair_active=None):
    """``phase_a_cuda`` (csrc/phase_a.cu) one row at a time, as its warp
    runs it: the chunk's groups in ascending 32-lane steps, each step's
    survivors appended in lane (ballot) order to a list of the first
    min(max(k0, kg), gpc) and all counted; unless the count passes k0, the
    listed groups' member leaves in 32-lane steps (two groups at lpg =
    16), the first min(k, keep_l) appended, the sweep stopped once the
    count passes that; then the row: group mode (count past k0, or leaves
    past min(k, keep_l), the two fallback rules) lists min(groups, gkeep,
    kg) groups padded with gpc to max(k, kg), leaf mode its leaves; lpc
    after; overflow where a group-mode row's groups pass kg or gkeep.

    bounds (Pb, 12) f32 [o_lo | o_hi | d_lo | d_hi]; without pair tables
    row r reads bounds r in chunk 0, with them row (p, s) reads bounds
    pair_gb[p] * S + s in chunk pair_c[p], empty unless pair_active[p].
    Tables of several chunks without pair tables take
    :func:`phase_a_chunk_model`. Returns (rows (nrows, rowlen) int32,
    overflow bool)."""
    cull = tables.cull
    if pair_c is None and cull.num_chunks > 1:
        return phase_a_chunk_model(bounds, tables, k0, k, kg, keep_l, gkeep,
                                   rowlen)
    lpg, lpc, nrl = (cull.leaves_per_group, cull.leaves_per_chunk,
                     cull.num_real_leaves)
    gpc = lpc // lpg
    bounds = np_(bounds)
    gmin, gmax = np_(cull.group_min).T, np_(cull.group_max).T   # (3, G)
    boxes = np_(tables.leaf_boxes).reshape(-1, 6, lpg)
    routed = pair_c is not None
    if routed:
        pc, pg, pa = np_(pair_c), np_(pair_gb), np_(pair_active)
        nrows = pc.shape[0] * S
    else:
        nrows = bounds.shape[0]
    glist, lcap = min(max(k0, kg), gpc), min(k, keep_l)
    rows = np.empty((nrows, rowlen), np.int32)
    overflow = False
    for r in range(nrows):
        chunk, b, active = 0, r, True
        if routed:
            p = r // S
            chunk, b, active = int(pc[p]), int(pg[p]) * S + r % S, bool(pa[p])
        g0 = chunk * gpc
        gl, gtotal = [], 0
        for base in range(0, gpc if active else 0, 32):
            lanes = np.arange(base, min(base + 32, gpc))
            g = g0 + lanes
            hit = ((g * lpg < nrl)
                   & _slab_lanes(bounds[b], gmin[:, g], gmax[:, g]))
            gl += lanes[hit][:max(glist - gtotal, 0)].tolist()
            gtotal += int(hit.sum())
        ll, ltotal = [], 0
        if gtotal <= k0:
            m = np.arange(gtotal * lpg)
            for base in range(0, m.shape[0], 32):
                if ltotal > lcap:
                    break
                mm = m[base:base + 32]
                grp = np.asarray(gl, np.int64)[mm // lpg]
                leaf = grp * lpg + mm % lpg
                bx = boxes[g0 + grp, :, mm % lpg].T              # (6, n)
                hit = ((chunk * lpc + leaf < nrl)
                       & _slab_lanes(bounds[b], bx[:3], bx[3:]))
                ll += leaf[hit][:max(lcap - ltotal, 0)].tolist()
                ltotal += int(hit.sum())
        use_g = gtotal > k0 or ltotal > lcap
        gcnt = min(gtotal, gkeep)
        gshow = min(gcnt, kg)
        row = np.full(rowlen, lpc, np.int32)
        if use_g:
            row[0] = -gshow
            row[1:max(k, kg) + 1] = gpc
            row[1:gshow + 1] = gl[:gshow]
            overflow |= gcnt > kg or gtotal > gkeep
        else:
            row[0] = ltotal
            row[1:ltotal + 1] = ll
        rows[r] = row
    return rows, overflow


def _refine(b, boxes, groups, lpg, nrl, keep_l, ll, ltotal):
    """csrc/phase_a.cu ``refine_groups``: the member leaves of ``groups``
    in 32-lane steps, the first keep_l appended to ``ll`` in ballot order,
    stopped once the count passes keep_l. Returns the count."""
    m = np.arange(len(groups) * lpg)
    for base in range(0, m.shape[0], 32):
        if ltotal > keep_l:
            break
        mm = m[base:base + 32]
        grp = np.asarray(groups, np.int64)[mm // lpg]
        leaf = grp * lpg + mm % lpg
        bx = boxes[grp, :, mm % lpg].T                          # (6, n)
        hit = (leaf < nrl) & _slab_lanes(b, bx[:3], bx[3:])
        ll += leaf[hit][:max(keep_l - ltotal, 0)].tolist()
        ltotal += int(hit.sum())
    return ltotal


def phase_a_chunk_model(bounds, tables, k0: int, k: int, kg: int,
                        keep_l: int, gkeep: int, rowlen: int):
    """``phase_a_cuda`` over tables of C > 1 chunks (csrc/phase_a.cu
    ``phase_a_chunk_rows``) one subpacket at a time, as its warp runs it:
    every group of every chunk in ascending 32-lane steps; a survivor's
    rank in its chunk (reset at each gpc boundary; ballot order) writes
    its chunk-relative id into the chunk's row while below kg, and the
    lane of a chunk's last group writes the chunk's count into the count
    column; while the survivors total at most k0 and the leaves at most
    keep_l, the survivors wait, and once 32 wait (and at the end) their
    member leaves are refined in 32-lane steps, the first keep_l appended
    to one list of global ids, the refine stopped once the count passes
    keep_l. Then per chunk c the count read back and its run of the leaf
    list (a binary search for the next chunk's first id), and its row
    finished: group mode (groups past k0, leaves past keep_l, or the
    chunk's own past k) keeps min(count, kg) groups, padded with gpc to
    max(k, kg), leaf mode writes its chunk-relative leaves; lpc after;
    overflow where a group-mode row's groups pass kg or all the groups
    pass gkeep.

    bounds (P, 12) f32. Returns (rows (C * P, rowlen) int32, chunk-major,
    overflow bool)."""
    cull = tables.cull
    C = cull.num_chunks
    lpg, lpc, nrl = (cull.leaves_per_group, cull.leaves_per_chunk,
                     cull.num_real_leaves)
    gpc = lpc // lpg
    G = C * gpc
    bounds = np_(bounds)
    P = bounds.shape[0]
    gmin, gmax = np_(cull.group_min).T, np_(cull.group_max).T   # (3, G)
    boxes = np_(tables.leaf_boxes).reshape(-1, 6, lpg)
    # The kernel writes into uninitialised rows: a value never written
    # shows as this.
    rows = np.full((C, P, rowlen), -(1 << 30), np.int32)
    overflow = False
    for p in range(P):
        o = rows[:, p]
        gtotal = ltotal = cc = 0
        ll, wait = [], []
        for s0 in range(0, G, 32):
            g = np.arange(s0, s0 + 32)
            ok = g < G
            hit = np.zeros(32, bool)
            hit[ok] = (g[ok] * lpg < nrl) & _slab_lanes(
                bounds[p], gmin[:, g[ok]], gmax[:, g[ok]])
            c = g // gpc
            first = np.maximum(c * gpc - s0, 0)
            rank = np.where(first == 0, cc, 0) + np.array(
                [hit[f:i].sum() for i, f in enumerate(first)])
            for i in np.flatnonzero(hit & (rank < kg)):
                o[c[i], 1 + rank[i]] = g[i] - c[i] * gpc
            for i in np.flatnonzero(ok & (g % gpc == gpc - 1)):
                o[c[i], 0] = rank[i] + hit[i]
            cc = 0 if (s0 + 32) % gpc == 0 else int(rank[31] + hit[31])
            gtotal += int(hit.sum())
            if gtotal > k0 or ltotal > keep_l:
                continue
            wait += g[hit].tolist()
            if len(wait) >= 32:
                ltotal = _refine(bounds[p], boxes, wait, lpg, nrl, keep_l,
                                 ll, ltotal)
                wait = []
        if gtotal <= k0:
            ltotal = _refine(bounds[p], boxes, wait, lpg, nrl, keep_l, ll,
                             ltotal)
        all_g = gtotal > k0 or ltotal > keep_l
        ll = np.asarray(ll, np.int64)
        lcut = np.searchsorted(ll, np.arange(C + 1) * lpc)
        for c in range(C):
            gcnt = int(o[c, 0])
            ls, le = lcut[c], lcut[c + 1]
            lcnt = int(le - ls)
            use_g = all_g or lcnt > k
            if use_g:
                gshow = min(gcnt, kg)
                o[c, 0] = -gshow
                o[c, gshow + 1:max(k, kg) + 1] = gpc
                o[c, max(k, kg) + 1:] = lpc
                overflow |= gcnt > kg or gtotal > gkeep
            else:
                o[c, 0] = lcnt
                o[c, 1:lcnt + 1] = ll[ls:le] - c * lpc
                o[c, lcnt + 1:] = lpc
    return rows.reshape(C * P, rowlen), overflow


def leaf_item_rows(cand, leaves_per_group: int, chunk: int):
    """The split leaf walks' items as rows of their own: (row (items,)
    int64, the item's row of the flattened (C, G, S) grid; sub (items,
    chunk + 1) int32 leaf-mode rows listing each item's walked leaves in
    walk order). Built from the plain walks' pair enumeration and the
    wrappers' item plan."""
    from tracer_torch.kernels import tilewalk as tw
    from tracer_torch.kernels.leafcull import _walk_pairs, walked_leaves
    walked = walked_leaves(cand, leaves_per_group)
    starts = tw.plan_items(walked, chunk)
    row, _, n = tw.item_table(starts, walked, chunk)
    q, leaf = _walk_pairs(cand.reshape(-1, cand.shape[-1]), leaves_per_group)
    w = walked.long()
    j = torch.arange(q.shape[0]) - (torch.cumsum(w, 0) - w)[q]
    sub = torch.zeros((row.shape[0], chunk + 1), dtype=torch.int32)
    sub[:, 0] = n.to(torch.int32)
    sub[starts[q].long() + j // chunk, 1 + j % chunk] = leaf.to(torch.int32)
    return row, sub


def np_items(walked, chunk: int) -> np.ndarray:
    """Every (row, first listed position, tiles) item of the tile walks'
    plan, by enumeration: (items, 3) int64."""
    return np.array([(r, f, min(chunk, w - f)) for r, w in enumerate(walked)
                     for f in range(0, w, chunk)], np.int64).reshape(-1, 3)


def scenes(c, r, a):
    """The same scene for both packages: (JAX Scene, port Scene)."""
    return fixed_scene(c, r, a), tt.scene_from_numpy(c, r, a, device="cpu")


@contextlib.contextmanager
def x64():
    """JAX in float64 for the block: an array made by :func:`f64` in it
    is float64, and so is every result computed from one (the f32
    constants of ``SoftParams`` and the camera promote)."""
    with jax.enable_x64(True):
        yield


def f64(x):
    """A float64 JAX array of x's values (inside :func:`x64`)."""
    return jnp.asarray(np.asarray(np_(x), np.float64))


def scene64(c, r, a):
    """The JAX scene of (c, r, a) in float64 (inside :func:`x64`)."""
    return JScene(centers=f64(c), radii=f64(r), albedo=f64(a))


def camera64(camera):
    """A JAX camera's pose and fov in float64 (inside :func:`x64`)."""
    return camera.replace(**{k: f64(getattr(camera, k)) for k in (
        "position", "yaw", "pitch", "fov")})


def bvhs(c, r, leaf_size: int):
    """One JAX BVH and the port's copy of it: (JAX FlatBVH, port FlatBVH)."""
    jb = jax_build_bvh(c, r, leaf_size=leaf_size)
    return jb, bvh_from_jax(jb)


def bvh_from_jax(jb):
    return tt.flat_bvh_from_numpy(np_(jb.node_min), np_(jb.node_max),
                                  np_(jb.escape), np_(jb.leaf_start),
                                  np_(jb.prim_idx), jb.leaf_size,
                                  device="cpu")


def assert_walk_t_close(t, t_ref, feats, slot, prims, rtol=1e-5):
    """Leaf-walk t (G, SP, S) against a reference at every hit slot.

    XLA on the CPU contracts mul+add into FMA where torch rounds each op,
    so the two differ by an ulp or so inside disc = b'^2 - a*c'. That is
    below ``rtol`` except on grazing rays (disc < 1e-3 * b'^2), where the
    sqrt amplifies it: there t may also differ by the propagated bound
    2^-20 * b'^2 / (a * sqrt(disc)), i.e. 16 ulps of b'^2 through the root.
    Off the origin, the JAX walks' c' = -2 o.c + (|c|^2 - r^2) + |o|^2 and
    b' = o.d - c.d cancel terms of size |2 o.c| + |o|^2 and |o.d| (the
    port's sums on oc = o - c do not): 16 ulps of those propagate as
    2^-20 * (|2 o.c| + |o|^2) / (2 a sqrt(disc)) + 2^-20 * |o.d| / a, which
    is zero for rays from the origin. ``feats`` and ``prims`` are the
    port's.
    """
    f = np_(jax_feats(feats)).transpose(0, 2, 1, 3).reshape(
        -1, feats.shape[-1])
    s = np_(slot).reshape(-1)
    hit = s < 2 ** 30
    f = f[hit].astype(np.float64)
    q = np_(jax_prims(prims)).reshape(-1, 4)[s[hit]].astype(np.float64)
    bp = f[:, 8] - (f[:, 0:3] * q[:, 0:3]).sum(1)
    cq = (f[:, 3:6] * q[:, 0:3]).sum(1) + q[:, 3] + f[:, 9]
    disc = bp * bp - f[:, 10] * cq
    graze = disc < 1e-3 * bp * bp
    got, want = np_(t).reshape(-1)[hit], np_(t_ref).reshape(-1)[hit]
    root = np.sqrt(np.maximum(disc, 1e-30))
    off = np.abs(f[:, 3:6] * q[:, 0:3]).sum(1) + np.abs(f[:, 9])
    tol = rtol * np.abs(want) + np.where(
        graze, 2.0 ** -20 * bp * bp / (f[:, 10] * root), 0.0) \
        + 2.0 ** -20 * (off / (2.0 * f[:, 10] * root)
                        + np.abs(f[:, 8]) / f[:, 10])
    bad = np.abs(got - want) > tol
    assert not bad.any(), (f"{bad.sum()} of {hit.sum()} hits outside "
                           f"tolerance ({graze.sum()} grazing)")


def assert_ray_t_close(t, t_ref, o, d, ids, centers, radii, rtol=1e-5):
    """Closest-hit t (B,) in ray order against a reference at every hit,
    where ``ids`` (B,) are the spheres both sides chose (-1 on miss): the
    leaf-walk tolerance of :func:`assert_walk_t_close`, each ray its own
    one-ray subpacket."""
    o, d = to_torch(o).reshape(-1, 3), to_torch(d).reshape(-1, 3)
    ids = to_torch(ids).reshape(-1).long()
    feats, _, _ = tt.pack_ray_features(o, d, 1, 1)
    c = to_torch(centers)[ids.clamp(min=0)]
    r = to_torch(radii)[ids.clamp(min=0)]
    prims = torch.cat([c, (r * r)[:, None]], dim=1)
    slot = torch.where(ids >= 0, torch.arange(ids.shape[0]), 2 ** 30)
    assert_walk_t_close(np_(t).reshape(-1, 1, 1), np_(t_ref).reshape(-1, 1, 1),
                        feats, slot.reshape(-1, 1, 1), prims, rtol=rtol)


def assert_cone_tables_match(jt, t):
    """The port's cone tables equal the JAX ones built from the same scene
    and tree: boxes, groups, slot map, leaf-box rows, r_max, and the prims
    of every real slot (``entries_to_prims``)."""
    jc, tc = jt.cull, t.cull
    for f in ("leaf_size", "leaves_per_group", "leaves_per_chunk",
              "num_leaves", "num_real_leaves", "num_chunks", "num_groups"):
        assert getattr(tc, f) == getattr(jc, f), f
    for f in ("leaf_min", "leaf_max", "group_min", "group_max",
              "slot_to_sphere"):
        np.testing.assert_array_equal(np_(getattr(tc, f)),
                                      np_(getattr(jc, f)), err_msg=f)
    np.testing.assert_array_equal(np_(t.leaf_boxes), np_(jt.leaf_boxes))
    assert t.r_max == jt.r_max
    prims = np_(jax_prims(tc.prims))
    real = np_(tc.slot_to_sphere).reshape(prims.shape[:2]) >= 0
    np.testing.assert_array_equal(
        prims[real], entries_to_prims(jc.entries, jc.leaf_size)[real])


def entries_to_prims(entries, leaf_size: int) -> np.ndarray:
    """JAX pair-packed, lane-replicated entries (C, Ec+1, 8, 128) -> the
    port's slot-major (C, lpc*leaf_size, 4) prim table layout."""
    e = np_(entries)[:, :-1]                        # drop the sentinel
    C, E = e.shape[:2]
    e = e[..., :leaf_size].reshape(C, E, 2, 4, leaf_size)  # leaf, attr, prim
    return e.transpose(0, 1, 2, 4, 3).reshape(C, E * 2 * leaf_size, 4)


def assert_occ_matches(occ, ref, o, d, centers, radii, t_max):
    """Occlusion flags (R,) against a reference: equal, except rays where
    some sphere sits within f32 rounding of the accept boundary (a graze,
    or a hit t within 1e-5 relative of t_max), the flip class
    tests/test_shadow.py allows; at most max(2, R // 200) of them."""
    occ, ref = np_(occ).astype(bool), np_(ref).astype(bool)
    bad = np.nonzero(occ != ref)[0]
    o = np_(o).astype(np.float64).reshape(-1, 3)
    d = np_(d).astype(np.float64).reshape(-1, 3)
    c = np_(centers).astype(np.float64)
    r = np_(radii).astype(np.float64)
    tm = np.broadcast_to(np_(t_max).astype(np.float64).reshape(-1),
                         occ.shape)
    for i in bad:
        oc = o[i][None] - c
        a = float(d[i] @ d[i])
        bp = oc @ d[i]
        cq = (oc * oc).sum(1) - r * r
        disc = bp * bp - a * cq
        graze = np.abs(disc) <= 4e-7 * np.maximum(bp * bp, np.abs(a * cq))
        with np.errstate(invalid="ignore"):
            t = np.where(disc > 0, (-bp - np.sqrt(np.maximum(disc, 0))) / a,
                         np.inf)
        near_tmax = np.abs(t - tm[i]) <= 1e-5 * tm[i]
        assert graze.any() or near_tmax.any(), \
            f"ray {i}: {occ[i]} vs {ref[i]}, no boundary case"
    assert len(bad) <= max(2, occ.size // 200), f"{len(bad)} flips"


def assert_sphere_t_close(t, t_ref, o, d, centers, rsq, rtol=1e-5):
    """t of the reference quadratic (b = 2 oc.d, c = |oc|^2 - r^2,
    disc = b^2 - 4ac, t = (-b - sqrt(disc)) / 2a) against another rounding
    of it, for rays (R, 3) and the (R, 3) centers / (R,) squared radii they
    hit: within ``rtol`` plus the propagated rounding of disc, whose terms
    cancel to |oc|^2-sized ulps: 2^-20 * (b^2 + 4a|oc|^2) / (4a sqrt(disc))
    bounds what FMA contraction moves t by (it dominates on grazing
    rays)."""
    o64 = np_(o).astype(np.float64).reshape(-1, 3)
    d64 = np_(d).astype(np.float64).reshape(-1, 3)
    oc = o64 - np_(centers).astype(np.float64).reshape(-1, 3)
    a = (d64 * d64).sum(1)
    bq = 2.0 * (oc * d64).sum(1)
    occ = (oc * oc).sum(1)
    disc = bq * bq - 4.0 * a * (occ - np_(rsq).astype(np.float64).reshape(-1))
    t, t_ref = np_(t).reshape(-1), np_(t_ref).reshape(-1)
    tol = rtol * np.abs(t_ref) + 2.0 ** -20 * (bq * bq + 4 * a * occ) \
        / (4 * a * np.sqrt(np.maximum(disc, 1e-30)))
    bad = np.abs(t - t_ref) > tol
    assert not bad.any(), f"{bad.sum()} of {t.size} hits outside tolerance"
