#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tracer_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. device check: exits 1 unless ``torch.cuda.is_available()``; prints the
   card's name and power limit as ``nvidia-smi`` reports them;
2. build: compiles the CUDA kernels under ``tracer_torch/csrc`` with nvcc;
3. kernel vs plain on the card: ``compact_cuda`` at the phase-A shapes of
   the 100k-sphere query, ``leafcull_cuda`` on phase-A rows at 20k spheres
   x 64k rays (default budgets, group-mode rows, and C > 1 chunks);
4. the slice at full size: 100k spheres x 512k origin rays through prep,
   phase A and the leaf walk, with launch counters reset just before and
   read just after; overflow, hit fraction, and agreement with the brute
   force oracle on the first 16k rays;
5. the headline measurement (``tracer_torch.bench``) and its JSON line;
6. one JSON line of per-kernel results, then the final status line.

Kernel and oracle disagreements are allowed only as ties (both t within
1e-5 relative) or grazes (for the prim one side chose, the quadratic's
discriminant is within 1e-5 * b'^2 of 0), on at most 0.01% of rays.
"""

import json
import subprocess
import sys

TIE_RTOL = 1e-5         # t of two different prims this close: a tie
GRAZE_RTOL = 1e-5       # |disc| <= GRAZE_RTOL * b'^2: a graze
T_RTOL = 1e-5           # t where both sides chose the same prim
MIN_AGREE = 0.9999      # share of rays whose choice must be equal
BRUTE_RAYS = 16384


def log(*a):
    print(*a, flush=True)


def classify(o, d, c, ccr, ta, tb, chosen_a, chosen_b):
    """Count ties, grazes and other disagreements among rays whose
    choices differ. o/d (R, 3); for side x in (a, b): chosen_x (R,) bool,
    t_x (R,), and the chosen prim's (c (R, 3), ccr (R,)) per side as
    c[x], ccr[x]."""
    import torch
    both = chosen_a & chosen_b
    tie = both & ((ta - tb).abs() <= TIE_RTOL * tb.abs())
    graze = torch.zeros_like(tie)
    o64, d64 = o.double(), d.double()
    for side, chosen in (("a", chosen_a), ("b", chosen_b)):
        cc, q = c[side].double(), ccr[side].double()
        bp = (o64 * d64).sum(-1) - (cc * d64).sum(-1)
        cq = (o64 * o64).sum(-1) - 2.0 * (o64 * cc).sum(-1) + q
        disc = bp * bp - (d64 * d64).sum(-1) * cq
        graze |= chosen & (disc.abs() <= GRAZE_RTOL * bp * bp)
    return int(tie.sum()), int((graze & ~tie).sum()), int((~(tie | graze)).sum())


def check_choices(name, o, d, prim_of, ta, sa, tb, sb, miss):
    """Hold two closest-hit results against each other; returns the max
    abs t difference where both chose the same prim. ``prim_of(s)`` maps
    choices to (centers, ccr); ``miss`` is the no-hit choice value."""
    import torch
    same = sa == sb
    agree = same.float().mean().item()
    hit = same & (sa != miss)
    terr = (ta[hit] - tb[hit]).abs()
    rel = (terr / tb[hit].abs()).max().item() if hit.any() else 0.0
    bad = ~same
    ca, qa = prim_of(sa[bad])
    cb, qb = prim_of(sb[bad])
    ties, grazes, other = classify(
        o[bad], d[bad], {"a": ca, "b": cb}, {"a": qa, "b": qb},
        ta[bad], tb[bad], sa[bad] != miss, sb[bad] != miss)
    log(f"{name}: {sa.numel()} rays, {int(hit.sum())} same hits, "
        f"slots agree on {agree:.6f}, max t rel err {rel:.3g}; "
        f"mismatches: {ties} tie(s), {grazes} graze(s), {other} other")
    if agree < MIN_AGREE or other or rel > T_RTOL:
        raise AssertionError(f"{name}: kernel and reference disagree")
    return terr.max().item() if hit.any() else 0.0


def walk_rays(feats):
    """Per-ray (o, d) in the leaf walk's (G, SP, S) output order."""
    f = feats.permute(0, 2, 1, 3).reshape(-1, feats.shape[-1])
    return -0.5 * f[:, 3:6], f[:, 0:3]


def compare_walk(name, feats, rows, cull):
    """leafcull_cuda vs leafcull_plain on the same inputs, per chunk."""
    import torch
    from tracer_torch.kernels.leafcull import (leafcull_cuda, leafcull_plain,
                                               _NOSLOT)
    args = (feats, rows, cull.prims, cull.leaf_size, cull.leaves_per_chunk,
            cull.leaves_per_group)
    tk, sk = leafcull_cuda(*args)
    tp, sp = leafcull_plain(*args)
    torch.cuda.synchronize()
    C = rows.shape[0]
    o, d = walk_rays(feats)
    o, d = o.repeat(C, 1), d.repeat(C, 1)
    flat = cull.prims.reshape(-1, 4)

    def prim_of(s):
        q = flat[s.clamp(max=flat.shape[0] - 1).long()]
        return q[:, :3], q[:, 3]

    return check_choices(name, o, d, prim_of, tk.reshape(-1), sk.reshape(-1),
                         tp.reshape(-1), sp.reshape(-1), _NOSLOT)


def tie_breaks(device):
    """leafcull_cuda on exact ties: one sphere stored twice in one chunk
    (slots 3 and 5, leaf 1 listed first) and once in each of two chunks.
    The lowest slot, then the lowest chunk, must win, as in the plain
    version."""
    import torch
    from tracer_torch.kernels.leafcull import leafcull_call, pack_ray_features
    sp, ls = 64, 4
    o = torch.zeros((sp, 3), device=device)
    d = torch.tensor([[1.0, 0.0, 0.0]], device=device).repeat(sp, 1)
    feats, _, _ = pack_ray_features(o, d, 1, sp)
    for slots, lists, want in (([[3, 5]], [[1, 0]], 3),
                               ([[1], [1]], [[0], [0]], 1)):
        prims = torch.zeros((len(slots), 2 * ls, 4), device=device)
        prims[..., 3] = 1e30
        rows = torch.full((len(slots), 1, 1, 8), 2, dtype=torch.int32,
                          device=device)
        for c, (cs, ids) in enumerate(zip(slots, lists)):
            for s in cs:
                prims[c, s] = torch.tensor([10.0, 0.0, 0.0, 99.0])
            rows[c, 0, 0, 0] = len(ids)
            rows[c, 0, 0, 1:1 + len(ids)] = torch.tensor(ids)
        _, slot = leafcull_call(feats, rows, prims, ls, 2, 16)
        _, plain = leafcull_call(feats.cpu(), rows.cpu(), prims.cpu(), ls, 2,
                                 16)
        if not ((slot.cpu() == want).all() and (plain == want).all()):
            raise AssertionError(f"tie-break: slots {slot.unique()} and "
                                 f"{plain.unique()}, want {want}")
    log("walk tie-breaks: lowest slot, then lowest chunk")


def masked_rows(P, M, gen, device):
    """(P, M) strictly ascending ids, masked at a per-row density; row 0
    all masked, row 1 none. Returns (ids, sentinel)."""
    import torch
    ids = torch.cumsum(torch.randint(1, 4, (P, M), generator=gen), 1)
    sentinel = 4 * M + 1
    mask = torch.rand(P, M, generator=gen) < torch.rand(P, 1, generator=gen)
    mask[0] = False
    mask[1] = True
    ids = torch.where(mask, ids, sentinel).to(torch.int32)
    return ids.to(device), sentinel


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    log(smi.stdout.strip())
    dev = torch.device("cuda")

    # -- 2. build --------------------------------------------------------
    from tracer_torch.kernels import _lib
    _lib.load()
    log(f"kernels built in {_lib.build_seconds:.1f} s")
    print(_lib.build_log, file=sys.stderr, flush=True)

    from tracer_torch.bench import headline
    from tracer_torch.bench.timing import time_cuda
    from tracer_torch.intersect.brute import brute_t_fast
    from tracer_torch.kernels.conecull import (cone_candidates, compact_cuda,
                                               compact_ascending_rows_plain)
    from tracer_torch.kernels.leafcull import leafcull_cuda, leafcull_plain

    # -- 3a. compact_cuda vs plain at the 100k query's phase-A shapes -----
    gen = torch.Generator().manual_seed(7)
    compact_ms = compact_plain_ms = 0.0
    for P, M, keep in ((4608, 384, 384), (4608, 1024, 512)):
        ids, sentinel = masked_rows(P, M, gen, dev)
        ok, ck = compact_cuda(ids, sentinel, keep)
        op, cp = compact_ascending_rows_plain(ids, sentinel, keep)
        torch.cuda.synchronize()
        if not (torch.equal(ok, op) and torch.equal(ck, cp)):
            raise AssertionError(f"compact_cuda != plain at ({P}, {M})")
        ms = time_cuda(compact_cuda, ids, sentinel, keep)
        pms = time_cuda(compact_ascending_rows_plain, ids, sentinel, keep)
        compact_ms += ms
        compact_plain_ms += pms
        log(f"compact ({P}, {M}) keep {keep}: equal; cuda {ms:.4f} ms, "
            f"plain {pms:.4f} ms")

    # -- 3b. leafcull_cuda vs plain on phase-A rows ----------------------
    walk_err = 0.0
    for name, mc, table_args in (
            ("walk 20k x 64k", headline.MC, {}),
            ("walk 20k x 64k, group mode", 7, {}),
            ("walk 20k x 64k, C > 1", headline.MC,
             {"max_chunk_bytes": 256 << 10})):
        _, tables, o, d, _ = headline.benchmark_inputs(
            dev, n_spheres=20_000, n_rays=65_536, world=500.0, **table_args)
        feats, _ = headline.prep(o, d)
        rows, _, _ = cone_candidates(feats, tables, headline.MG, mc)
        rows = rows.reshape(tables.cull.num_chunks, feats.shape[0],
                            headline.S, rows.shape[-1])
        if mc == 7 and not (rows[..., 0] < 0).any():
            raise AssertionError("budget 7 made no group-mode row")
        if table_args and tables.cull.num_chunks < 2:
            raise AssertionError("small max_chunk_bytes kept one chunk")
        walk_err = max(walk_err, compare_walk(
            f"{name} ({tables.cull.num_chunks} chunk(s))", feats, rows,
            tables.cull))

    tie_breaks(dev)

    # -- 4. the slice at full size ---------------------------------------
    scene, tables, o, d, build_ms = headline.benchmark_inputs(dev)
    cull = tables.cull
    log(f"100k scene: bvh build {build_ms:.1f} ms, {cull.num_chunks} "
        f"chunk(s), {cull.num_real_leaves} leaves")
    leafcull_cuda.launches = 0
    compact_cuda.launches = 0
    t, slot, dest, overflow = headline.query(o, d, tables)
    torch.cuda.synchronize()
    launches = {"leafcull_cuda": leafcull_cuda.launches,
                "compact_cuda": compact_cuda.launches}
    log(f"slice launches: {launches}")
    if min(launches.values()) < 1:
        raise AssertionError("the slice did not run through every kernel")
    if bool(overflow):
        raise AssertionError("phase A overflowed at the bench budgets")
    tr, sr = t[dest], slot[dest]
    hit_fraction = torch.isfinite(tr).float().mean().item()
    log(f"slice: {o.shape[0]} rays, hit fraction {hit_fraction:.4f}")
    if not 0.03 <= hit_fraction <= 0.07:
        raise AssertionError(f"hit fraction {hit_fraction} outside 0.03-0.07")
    sid = torch.where(sr >= 0, cull.slot_to_sphere[sr.clamp(min=0).long()],
                      -1)
    n = BRUTE_RAYS
    tb, ib = brute_t_fast(o[:n], d[:n], scene.centers, scene.radii,
                          block=1024)
    centers, radii = scene.centers, scene.radii

    def sphere_of(s):
        s = s.clamp(min=0).long()
        c = centers[s]
        return c, (c * c).sum(-1) - radii[s] * radii[s]

    check_choices(f"slice vs brute_t_fast (first {n} rays)", o[:n], d[:n],
                  sphere_of, tr[:n], sid[:n], tb, ib, -1)

    # Kernel times at the query's own shapes, beside the plain versions.
    feats, _ = headline.prep(o, d)
    rows = cone_candidates(feats, tables, headline.MG, headline.MC)[0]
    rows = rows.reshape(cull.num_chunks, feats.shape[0], headline.S,
                        rows.shape[-1])
    walk_err = max(walk_err, compare_walk("walk 100k x 512k", feats, rows,
                                          cull))
    args = (feats, rows, cull.prims, cull.leaf_size, cull.leaves_per_chunk,
            cull.leaves_per_group)
    walk_ms = time_cuda(leafcull_cuda, *args)
    walk_plain_ms = time_cuda(leafcull_plain, *args, warmup=1, iters=3)
    log(f"walk 100k x 512k: cuda {walk_ms:.4f} ms, plain "
        f"{walk_plain_ms:.4f} ms")

    # -- 5. headline -------------------------------------------------------
    log(json.dumps(headline.measure(tables, o, d, build_ms)))

    # -- 6. results ---------------------------------------------------------
    log(json.dumps({"kernels": [
        {"name": "leafcull_cuda", "route": "cuda",
         "source": "tracer_torch/csrc/leafcull.cu",
         "replaces": "tracer/kernels/leafcull.py:515",
         "launches": launches["leafcull_cuda"], "max_abs_err": walk_err,
         "ms": walk_ms, "plain_ms": walk_plain_ms},
        {"name": "compact_cuda", "route": "cuda",
         "source": "tracer_torch/csrc/compact.cu",
         "replaces": "tracer/kernels/conecull.py:414",
         "launches": launches["compact_cuda"], "max_abs_err": 0,
         "ms": compact_ms, "plain_ms": compact_plain_ms},
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
