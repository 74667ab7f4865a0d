#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tracer_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

(``--compact-baseline FILE.cu`` adds another compactor to phase 7b.)

Phases, each of which raises on failure (the script then exits non-zero):

1. device check: exits 1 unless ``torch.cuda.is_available()``; prints the
   card's name and power limit as ``nvidia-smi`` reports them;
2. build: compiles the CUDA kernels under ``tracer_torch/csrc`` with nvcc,
   one process per source, all at once;
3. kernel vs plain on the card: ``compact_cuda`` at the phase-A shapes of
   the 100k-sphere query (synthetic planes); ``leafcull_cuda``,
   ``conecull_cuda`` (phase B) and ``anyhit_cuda`` on phase-A rows at 20k
   spheres x 64k rays (default budgets, group-mode rows, C > 1 chunks, for
   phase B also unsorted rays whose cones are degenerate, and for any-hit
   a dense scene where whole subpackets are occluded); ``leafcull_cuda``,
   ``anyhit_cuda`` and ``conecull_cuda`` on skewed rows at SP = 64 and 128
   in C > 1 chunks (one row per chunk walks every group, the others 1-2
   leaves); ``routed_cuda`` on TLAS rows at 20k
   spheres in 8 chunks, where the routed query must also equal the dense
   multi-chunk one, and on skewed routed rows (the first row of each
   chunk's first pair walks every group, the others 1-2 leaves);
3c. prep (``prep_slice``): ``prep_cuda`` against the torch operations it
   replaces (``prep_feats_plain``), rows as bits and dest equal, at the
   shapes of the cells that run it (``PREP_SHAPES``: query_100k's 524,288
   rays at cell bits 9, query_10m's 131,072, path_100k's 480,000 with
   98.8 % parked at +x, and a shadow prep with t_max), each call
   ``PREP_LAUNCHES`` launches, its ``prep`` span reading ``prep_kernel``
   1; both timed on CUDA events and by the
   profiler's device time, and the bound;
4. the closest-hit slice at full size: 100k spheres x 512k origin rays
   through prep, phase A and the leaf walk, its kernel launches counted
   (``_lib.launches``) from just before to just after; overflow, hit
   fraction, and agreement
   with the brute-force oracle on the first 16k rays; ``phase_a_cuda``
   against the torch operations it replaces on the slice's subpacket
   bounds, bit for bit, timed beside them and its bound; kernel vs plain
   on its rows and their walked-leaf distribution;
5. the shadow slice at full size: the same rays with t_max = 500 through
   prep, phase A and the any-hit walk, launches counted the same way;
   overflow, agreement with "closest-hit t < 500" from phase 4 on every
   ray and with ``any_hit_brute`` on the first 16k rays;
   ``phase_a_cuda`` against the torch operations on its bounds; kernel vs
   plain on its rows and their walked-leaf distribution;
5b. the packet cull at full size: 100k spheres in 16-prim leaves, the
   512k rays sorted by direction, through ``nearest_hit_cull_checked`` from
   K = 128, launches counted the same way; no overflow at the budget
   it settles on, agreement with a b-form brute force (its own rounding)
   and with ``nearest_hit_brute_fast`` on the first 16k rays; kernel vs
   plain on its candidates;
5c. phase B at full size: the same rays through ``prep_rays_bucketed``,
   phase A with cones and ``conecull_cuda`` (``nearest_hit_conecull_t``
   with budget doubling), on the headline tables (leaf 32) and on 16-prim
   leaves, launches counted the same way; no overflow; at leaf 32
   ids and t equal the headline leaf-walk query's on every ray; agreement
   with brute force on the first 16k rays; kernel vs plain and vs
   ``leafcull_cuda`` on its rows, all bit for bit; its rows' walked
   leaves;
6. the 10M TLAS slice at full size: 10M spheres, device LBVH, 131k origin
   rays through prep, routing, routed phase A, the routed walk and the
   merge, launches counted the same way; overflow, slots equal to
   the dense multi-chunk query on every ray, agreement with brute force on
   the first 4096 rays; ``phase_a_cuda`` against the torch operations on
   every routed pair, timed beside them and its bound, then on skewed
   rows (``skewed_phase_a``: one-chunk rows on the 100k tables from
   hair-thin direction boxes to ones that meet every group, at the bench
   budget and at 16 leaves, in group mode and overflowing; routed rows on
   the 10M tables over random chunks, the last included, every fifth pair
   inactive, at 119 and 7 leaves); kernel vs plain on its rows, their
   walked-leaf distribution and the keys' bytes;
7a. phase A at several chunks (``render_phase_a``): the ``path_100k``
   cell's tables (``render_100k``: 100k spheres, leaf 16, three chunks)
   and the CLI render's (three chunks); one frame each with
   ``cone_candidates``' calls recorded and the trace on, each call
   launching ``phase_a_cuda`` once and its ``phase_a`` span reading
   ``phase_a_kernel`` 1; the kernel against the torch operations, rows
   and flag bit for bit, on every call's bounds at its budgets; on the
   cell's tables also the camera rays and the rays leaving the first hit
   points at every rung of ``leafcull._escalate``'s ladder up to (G,
   lpc), timed beside them and its bound;
7. the render slice at full size: 100k spheres in the 1000-unit world,
   the default camera, 800x600, through ``tracer_torch.cli``'s own code
   path, in path mode (depth 5) and direct mode, both with compaction,
   each with ``--impl auto``, ``pallas`` and ``tilecull`` on one shared
   noise tensor; launches counted over the six frames; the images held
   against each other and the primary ids against brute force;
   ``traverse_cuda`` and ``tilecull_cuda`` held against their plain
   versions on the frame's primary rays; the walks on the arguments the
   frames gave them (every leaf walk of the path/auto frame with its rows,
   time and bound, the heaviest also against its plain version; the
   direct/auto any-hit walk; every packet walk of the path/pallas
   frame against its plain version, with its steps per packet, time, time
   per step of its longest packet and bound; the direct/pallas packet
   walk against its plain version); one metrics JSON line per (mode,
   impl);
7b. the compactor on the planes each main path of phases 4-7 gave it
   (its calls recorded while the launches were counted, checked as soon
   as the path's counts are read, then dropped): ``compact_cuda`` equal
   to its plain version on every plane; timed on the headline's two phase-A
   planes, the ``tile_candidates`` planes of the packet cull (ragged:
   1102 tiles) and the render, and the 10M routing planes; per path the
   launches' (P, M, keep) shapes and their summed device time
   (``tracer_torch.bench.compact``), and the sum over every path. With
   ``--compact-baseline FILE.cu`` another compactor source (an older
   checkout's ``csrc/compact.cu``) is held equal and timed beside it on
   the same planes;
7c. the differentiable path on the 100k scene (``diff_slice``): the
   bench extra's fwd+bwd (131,072 rays, 2,304 subpackets of 64, the
   leaf-order sparse soft image at 16 leaves a subpacket, the gradient of
   its mean with respect to the centres) once with its launches counted,
   its compactions checked as in 7b;
   ``leaf_candidates`` at that shape equal with ``compact_cuda`` and with
   the plain compactor, and timed; on tables from radii inflated by
   ``soft_radius_scale``, 1,024 sorted rays at 64 leaves: the sparse soft
   image against the dense one (atol 5e-3), the leaf-order image and
   gradient against the exact packets path's (logged) and against the
   same function on the CPU (atol 1e-5, gradient 1e-4 max + 1e-7); the
   the dense image and sigma in f32 against the same port functions in
   float64 on the card (the image within 2e-3; the leaf-order image
   against the float64 one logged); the
   extra's forward, backward, Mrays/s and peak memory, its gradient finite
   and not all zero; ``cli fit`` at 800x600 and 20 spheres in a temporary
   directory (20 steps, the loss falling; 10 steps, a checkpoint and a
   resume to 20, bitwise the straight run); ``fit_scene`` with
   ``optimize_camera=True`` at 800x600 from the true scene and the pose
   off by 0.02 rad in yaw and 0.1 in x, 20 steps at lr 3e-3, its view
   error at least halved, and without ``optimize_camera`` the camera
   returned as passed; the fwd+bwd, its forward and
   a fit step profiled; the identity refit of the 100k tree equal to the
   build, and timed;
7d. the soft evaluation's kernel (``soft_slice``): the checked soft
   evaluation at grad_131k's shapes through ``soft_cuda``
   (``csrc/soft.cu``), its plain version on the card and autograd over
   ``diff.sparse._soft_block``; image, loss and gradients held to each
   other, every ``composite`` span reading ``soft_kernel`` 1, the
   kernel's launches an evaluation, the composite and backward of each
   timed on CUDA events, the kernels by name on the profiler's device
   time, and the bound;
8. the headline measurement (``tracer_torch.bench``, with its shadow,
   LBVH and differentiable extras) and the large-scene measurement
   (``tracer_torch.bench.large``), one JSON line each;
8b. the sweep (``sweep_slice``): ``cli bench`` at 1k, 10k, 100k, 1M, 10M
   and 100M spheres x 131,072 origin rays in a temporary directory, every
   kernel's launches counted from just before to just after; per row its
   path, build, brute and BVH times, Mrays/s, table chunks, settled
   budgets, escalations, scene and table times, peak memory, seconds of
   run and the kernels its query launches (dense: none; single chunk:
   ``leafcull_cuda`` and ``phase_a_cuda``; routed: ``routed_cuda``,
   ``compact_cuda`` and ``phase_a_cuda``), no escalation of a routed row of at most 256 chunks
   at the JAX harness's budgets, and its t and ids against brute force on
   the rays brute force timed (ties and grazes only, t to 1e-5 relative
   but at a graze); the complexity fit. The 100M row (more than 256
   chunks, brute force skipped, its scene freed by the sweep) is held
   against brute force on its first 1,024 rays over the scene drawn again
   from its seed; ``phase_a_cuda`` on its first block of pairs (the
   ``pair_block`` the torch operations take at a time) against the torch
   operations and against its own launch over every pair, timed; its
   routed rows' first 2,048 pairs through
   ``routed_cuda`` against ``routed_plain`` bit for bit; its stage times,
   launches, walk bound and compactor planes (``routed_row``); then the
   same tables at the published sweep's 524,288 rays: the query settled
   and timed, and ``routed_row`` again;
8c. the render flags, debug and viz (``tools_slice``): ``cli render``
   path/auto at 800x600, 100k spheres, ``--compact``: 4 frames straight
   with ``--checkpoint`` against 2 frames and ``--frames 4 --resume``,
   bitwise, still and at ``--fly-speed 1``; ``--profile`` over two frames,
   the trace naming a kernel of the port; two frames under
   ``TRACER_DEBUG=1`` equal to two unchecked ones, with both frame times;
   ``checked_nearest_hit`` on 4,096 headline rays over the 16-prim tree,
   clean and with a NaN direction (which must raise); ``cli viz`` at
   800x600;
8d. the distribution (``dist_slice``) at world size 1 over NCCL, each
   query timed beside its unsharded twin, the group's start timed:
   ``nearest_hit_sharded`` on the headline query bitwise the unsharded
   query, launching ``phase_a_cuda`` and ``leafcull_cuda`` once each
   (launches counted from just before to just after); ``measure_scaling``
   with one rank; ``render_sharded`` path frames at 800x600, 100k spheres,
   ``--impl auto`` (leaf walk and phase A kernel launched) and ``pallas``
   (packet walk launched), bitwise ``render`` on the same noise; the ring
   at 100,352 spheres x 1,024 rays, brute force and through a one-shard
   ``build_sharded_bvh`` tree, against ``nearest_hit_brute`` (ties and
   grazes only); ``make_train_step`` on a (1, 1) mesh at 800x600 and 20
   spheres (its loss soft_render's to 1e-5 relative, its gradient, 0.1 g
   from Adam's first moment, the unsharded gradient's to 1e-5 of the
   largest: at R = S = 1 the division by R * S is by 1, so the repair
   cannot show on one card, and the gloo tests hold it; two steps moving
   the centres); ``fit_scene(mesh=ray_mesh(1))`` for 5 steps, bitwise the
   unsharded fit with one all-reduce, and with 4 gradient microbatches
   its losses to 1e-5 relative and its centres to 3e-5 (1e-3 of Adam's
   step); the group destroyed; then ``nearest_hit_leafcull_t`` on the
   sorted headline rays (budgets doubled until no overflow; the leaf walk
   once, the compactor twice), its ids ``nearest_hit_leafcull``'s and its
   t within 1e-4 relative;
9. one JSON line of per-kernel results, then the final status line.

Phase 3 also holds ``traverse_cuda`` and ``tilecull_cuda`` against their
plain versions at 20k spheres x 64k rays: a ragged tail, divergent packets
(one of live rays spread through the scene, one half parked, six parked,
a live tail), a 2-D batch through the wrappers, a tile budget of one
(overflowing rows), rows that list the sentinel tile and skewed rows (one
lists every tile, the others 1-2); t, slots and steps must be equal
exactly. And ``cull_cuda`` against
its plain version at 20k spheres x (64k + 37) direction-sorted rays: the
full budget, an overflowing budget of 8 tiles (the walk stops at K), skewed
rows, and the sentinel tile listed after every packet's own tiles. Beside
the two timed tile walks (phases 5b and 7) it logs the row-length
distribution, and beside the timed leaf walks (phases 4, 5 and 7) the
walked leaves per row (mean, p99, max, total) and the share of rows in
group mode.

Closest-hit disagreements with an oracle are allowed only as ties (both t
within 1e-5 relative) or grazes (for the prim one side chose, the
quadratic's discriminant is within 1e-5 * b'^2 of 0), on at most 0.01% of
rays (against an oracle that rounds the quadratic another way, on rays off
the origin, see MIN_AGREE_OTHER_ROUNDING); occlusion disagreements only as
grazes or a hit t within 1e-5 of t_max, on at most 0.01% of rays (0.5% against ``any_hit_brute``, whose
reference quadratic rounds differently, see MIN_AGREE_REFERENCE). Every
kernel equals its plain version exactly.

``compact_cuda``'s ``launches`` in the per-kernel line is its count on
the differentiable path (phase 7c): the headline query no longer calls
it; every other kernel's is its own path's count. ``phase_a_cuda``'s
``ms``, ``plain_ms`` and ``bound_ms`` are the headline's (phase 4), with
the 10M rows' (``*_10m``) and the render's three-chunk camera rows at the
render's budgets (``*_chunks``, phase 7a) beside them. ``prep_cuda``'s
are those of query_100k's shape (phase 3c), with query_10m's (``*_10m``)
and path_100k's (``*_path``) beside them; its ``ms`` is the whole call,
the sort's launches included.

Each kernel's ``ms`` in the per-kernel line is its wrapper's call timed
on CUDA events over back-to-back calls; ``compact_cuda``'s is summed over
the two synthetic planes of phase 3a. The calls of ``compact_cuda``,
``phase_a_cuda`` and ``conecull_cuda`` take less device time than the host takes to issue
them, so their device time (the call captured in a CUDA graph and
replayed between CUDA events: ``timing.time_graph``) is logged beside.
Each kernel's ``bound_ms`` is the larger of its bytes (each input read
once, each output written once) over 3.35 TB/s and its operations over
67 TFLOP/s (the H100's fp32 rate outside the tensor cores): 19 fp32
operations per (ray, prim) test, counted over the tests this run's rows
need (for the any-hit walk, up to the leaf where every ray of the
subpacket is occluded), and for the compactor 3 32-bit operations per id
(its bound is bytes: each plane read once, prefix and counts written once).
The packet walk counts 25 operations per (ray, node) slab test over the
nodes each packet visited (steps x 1024) and 25 per b-form (ray, prim)
test over the leaves it tested (leaf visits x leaf size x 1024); the tile
walk 20 per (ray, prim) test over the listed tiles (sum of counts x 128 x
128); phase B 22 per cone test of a walked prim and 19 per (ray,
survivor) test; the packet cull 25 per b-form test over the walked tiles
(sum of min(count, K) x 1024 x 128); phase A 85 per interval slab test of
a box, over every group of an active row's chunk (every chunk's, for the
rows of tables of several chunks) and the member leaves of the groups of
rows that meet at most k0 (its bytes: the rows written, the
bounds, group boxes, leaf boxes and pair tables read once).
"""

import contextlib
import json
import subprocess
import sys
import time

TIE_RTOL = 1e-5         # t of two different prims this close: a tie
GRAZE_RTOL = 1e-5       # |disc| <= GRAZE_RTOL * b'^2: a graze
T_RTOL = 1e-5           # t where both sides chose the same prim
TMAX_RTOL = 1e-5        # hit t this close to t_max: a clip flip
MIN_AGREE = 0.9999      # share of rays whose choice must be equal
# any_hit_brute computes the reference quadratic (b = 2 oc.d, disc =
# b^2 - 4ac), the walks' sums on oc = o - c times exact powers of two; it
# accepts on t > EPSILON and t < t_max where the walks compare u, so the
# two can part only at those bounds. Its flips are held to the JAX shadow
# test's budget (tests/test_shadow.py), set when the walks expanded the
# quadratic and ~1 % of hits at this scene's distances lay in the graze
# band.
MIN_AGREE_REFERENCE = 0.995
BRUTE_RAYS = 16384
BRUTE_RAYS_10M = 4096
BRUTE_RAYS_100M = 1024  # the 100M sweep row's rays held to brute force
PAIR_SLICE = 2048       # its routed pairs held to the plain walk
PUBLISHED_RAYS = 524288  # the rays of the JAX package's published sweep
SMALL_T_MAX = 150.0     # shadow t_max in the 20k settings (world 500)
DENSE_MG = 2048         # dense 10M comparison: group budget (no overflow)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
OPS_PER_TEST = 20       # fp32 operations of one (ray, prim) test: 17 to disc
OPS_PER_ID = 3          # compactor: compare, scan add, store index
OPS_PER_SLAB = 25       # packet walk: one (ray, node) slab test
OPS_PER_BFORM = 25      # packet walk: one b-form (ray, prim) test
OPS_PER_TILE_TEST = OPS_PER_TEST + 1    # tile walk: the test plus t = -u/a
OPS_PER_CONE = 22       # phase B: one cone test of a walked prim
OPS_PER_BOX = 85        # phase A: one interval slab test of a box
CULL_K = 128            # the packet cull's first budget at full size
SMALL_CULL_K = 8        # an overflowing packet-cull budget at 20k spheres
PLAIN_ELEMS = 1 << 26   # slice size of the plain walks on the card
# The packet walk keeps the JAX kernel's b-form quadratic (b = 2 oc.d); the
# leaf and tile walks (and brute_t_fast) take its sums halved, on
# oc = o - c, and so the same sign of disc. When they expanded
# |o|^2 - 2 o.c + (|c|^2 - r^2) instead, at 100k spheres of r = 0.5 in a
# 1000-unit world seen from the default camera at (0, 4, 50), that
# cancelled terms of size |c|^2 ~ 1e5 down to r^2 = 0.25 and the two
# roundings disagreed on a few tenths of a percent of primary rays (46 of
# 20,000 in a numpy f32 model of this frame), every one at a graze.
# Agreement between results rounded in different orders is held to this
# share; each path is also held at MIN_AGREE against an oracle with its
# own rounding.
MIN_AGREE_OTHER_ROUNDING = 0.99
WALK_SPHERES, WALK_RAYS = 20_000, 65_536   # packet and tile walk settings
LONG_WALK = 1000        # packets over this many steps are logged
RENDER_FRAMES = 3       # timed frames per (mode, impl); the first dropped
OFF_ORIGIN_RAYS = 131_072   # rays of the off-origin walk checks
# The walks' times on this script's origin rows (CUDA events) with the
# expanded quadratic |o|^2 - 2 o.c + (|c|^2 - r^2) that the test on
# oc = o - c replaced, measured by this script on an NVIDIA H100 80GB HBM3
# at 700 W: printed beside today's.
EXPANDED_MS = {"walk 100k x 512k": 0.9483, "any-hit 100k x 512k": 1.0973,
               "routed 10M": 15.0131}
PIXEL_ATOL = 1e-5       # two renders of a pixel agree within this


def log(*a):
    print(*a, flush=True)


def launches_since(before, *names):
    """{name: launches} of the kernel wrappers ``names`` since ``before``,
    a copy of ``_lib.launches``."""
    from tracer_torch.kernels import _lib
    return {k: _lib.launches[k] - before[k] for k in names}


@contextlib.contextmanager
def uncounted():
    """The block's kernel launches left out of ``_lib.launches``: a check's
    own launches are not the path's."""
    from tracer_torch.kernels import _lib
    saved = _lib.launches.copy()
    try:
        yield
    finally:
        _lib.launches.clear()
        _lib.launches.update(saved)


def grazing(o, d, c, ccr):
    """Rays (o, d (R, 3)) that graze their prim (c (R, 3), ccr (R,) =
    |c|^2 - r^2): the quadratic's |disc| <= GRAZE_RTOL * b'^2, in f64."""
    o64, d64 = o.double(), d.double()
    cc, q = c.double(), ccr.double()
    bp = (o64 * d64).sum(-1) - (cc * d64).sum(-1)
    cq = (o64 * o64).sum(-1) - 2.0 * (o64 * cc).sum(-1) + q
    disc = bp * bp - (d64 * d64).sum(-1) * cq
    return disc.abs() <= GRAZE_RTOL * bp * bp


def classify(o, d, c, ccr, ta, tb, chosen_a, chosen_b):
    """Count ties, grazes and other disagreements among rays whose
    choices differ. o/d (R, 3); for side x in (a, b): chosen_x (R,) bool,
    t_x (R,), and the chosen prim's (c (R, 3), ccr (R,)) per side as
    c[x], ccr[x]."""
    import torch
    both = chosen_a & chosen_b
    tie = both & ((ta - tb).abs() <= TIE_RTOL * tb.abs())
    graze = torch.zeros_like(tie)
    for side, chosen in (("a", chosen_a), ("b", chosen_b)):
        graze |= chosen & grazing(o, d, c[side], ccr[side])
    return int(tie.sum()), int((graze & ~tie).sum()), int((~(tie | graze)).sum())


def check_choices(name, o, d, prim_of, ta, sa, tb, sb, miss,
                  min_agree=MIN_AGREE):
    """Hold two closest-hit results against each other; returns the max
    abs t difference where both chose the same prim. ``prim_of(s)`` maps
    choices to (centers, ccr); ``miss`` is the no-hit choice value."""
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
    if agree < min_agree or other or rel > T_RTOL:
        raise AssertionError(f"{name}: kernel and reference disagree")
    return terr.max().item() if hit.any() else 0.0


def check_occlusion(name, o, d, occ_a, occ_b, centers, radii, t_max,
                    min_agree=MIN_AGREE):
    """Hold two occlusion results (R,) bool against each other: a ray may
    differ only where some sphere grazes it or is hit within TMAX_RTOL of
    t_max, on at most 1 - min_agree of the rays."""
    import torch
    bad = (occ_a != occ_b).nonzero().reshape(-1)
    share = 1.0 - bad.numel() / occ_a.numel()
    if share < min_agree:
        raise AssertionError(f"{name}: occlusion agrees on {share:.6f}")
    explained = 0
    for i in bad.tolist():
        o64, d64 = o[i].double(), d[i].double()
        oc = o64[None] - centers.double()
        a = (d64 * d64).sum()
        bp = oc @ d64
        cq = (oc * oc).sum(1) - radii.double() ** 2
        disc = bp * bp - a * cq
        graze = disc.abs() <= GRAZE_RTOL * torch.maximum(bp * bp,
                                                         (a * cq).abs())
        t = (-bp - disc.clamp(min=0).sqrt()) / a
        near = (disc > 0) & ((t - t_max).abs() <= TMAX_RTOL * t_max)
        explained += bool((graze | near).any())
    log(f"{name}: {occ_a.numel()} rays, {int(occ_b.sum())} occluded, "
        f"agree on {share:.6f}; {bad.numel()} mismatch(es), "
        f"{explained} at a graze or at t_max")
    if explained < bad.numel():
        raise AssertionError(f"{name}: occlusion results disagree")


def walk_args(feats, rows, cull):
    return (feats, rows, cull.prims, cull.leaf_size, cull.leaves_per_chunk,
            cull.leaves_per_group)


def compare_walk(name, feats, rows, cull):
    """leafcull_cuda vs leafcull_plain on the same inputs, per chunk: t and
    slots equal bit for bit."""
    import torch
    from tracer_torch.kernels.leafcull import leafcull_cuda, leafcull_plain
    args = walk_args(feats, rows, cull)
    tk, sk = leafcull_cuda(*args)
    tp, sp = leafcull_plain(*args, pair_elems=PLAIN_ELEMS)
    torch.cuda.synchronize()
    if not (torch.equal(sk, sp) and torch.equal(tk, tp)):
        raise AssertionError(f"{name}: leafcull_cuda != plain on "
                             f"{int((sk != sp).sum())} slot(s), "
                             f"{int((tk != tp).sum())} t value(s)")
    log(f"{name}: {sk.numel()} ray results, {int((sk < 2 ** 30).sum())} "
        f"hits; t and slots equal bit for bit")


def compare_anyhit(name, feats, rows, cull):
    """anyhit_cuda vs anyhit_plain: flags equal exactly. Returns the
    number of subpackets whose rays are all occluded (where the kernel
    can exit early)."""
    import torch
    from tracer_torch.kernels.leafcull import anyhit_cuda, anyhit_plain
    args = walk_args(feats, rows, cull)
    ok = anyhit_cuda(*args)
    op = anyhit_plain(*args, pair_elems=PLAIN_ELEMS)
    torch.cuda.synchronize()
    if not torch.equal(ok, op):
        raise AssertionError(f"{name}: anyhit_cuda != plain on "
                             f"{int((ok != op).sum())} rays")
    full = int(op.bool().all(dim=1).sum())
    log(f"{name}: flags equal on {ok.numel()} rays, {int(op.sum())} "
        f"occluded, {full} fully occluded subpacket(s)")
    return full


def compare_routed(name, args):
    """routed_cuda vs routed_plain: (t, slot) equal bit for bit."""
    import torch
    from tracer_torch.kernels.tlas import routed_cuda, routed_plain
    tk, sk = routed_cuda(*args)
    tp, sp = routed_plain(*args, pair_elems=PLAIN_ELEMS)
    torch.cuda.synchronize()
    if not (torch.equal(sk, sp) and torch.equal(tk, tp)):
        raise AssertionError(f"{name}: routed_cuda != plain on "
                             f"{int((sk != sp).sum())} slot(s), "
                             f"{int((tk != tp).sum())} t value(s)")
    log(f"{name}: {args[0].shape[0]} pairs, {int((sk < 2 ** 30).sum())} "
        f"hits; t and slots equal bit for bit")


def off_origin_rays(scene, n, seed):
    """(o, d) of n unit rays that start off the world's origin, as a
    frame's do: half from points around the camera at (0, 4, 50) into the
    half-space it faces, half from points on random spheres, outwards."""
    import torch
    dev = scene.centers.device
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(m):
        return torch.randn((m, 3), generator=gen, device=dev)
    h = n // 2
    o1 = torch.tensor([0.0, 4.0, 50.0], device=dev) + randn(h)
    d1 = randn(h)
    d1[:, 2] = -d1[:, 2].abs()
    idx = torch.randint(0, scene.centers.shape[0], (n - h,), generator=gen,
                        device=dev)
    nrm = torch.nn.functional.normalize(randn(n - h), dim=1)
    o2 = scene.centers[idx] + scene.radii[idx, None] * nrm
    d2 = nrm + 0.8 * randn(n - h)
    d = torch.nn.functional.normalize(torch.cat([d1, d2]), dim=1)
    return torch.cat([o1, o2]).contiguous(), d.contiguous()


def log_beside_expanded(name, ms):
    """A walk's time on the origin rows beside its expanded-form time."""
    was = EXPANDED_MS[name]
    log(f"{name}: cuda {ms:.4f} ms on the test on oc = o - c, "
        f"{was:.4f} ms with the expanded quadratic ({ms / was - 1:+.1%})")


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


# Prep's shapes (phase 3c): (name, rays, subpackets, subpacket, cell bits,
# share of live rays, the rest parked at +x from 1e18 as the renderer parks
# dead rays, and whether each ray has a t_max).
PREP_SHAPES = (("query_100k", 524_288, 8, 128, 9, 1.0, False),
               ("query_10m", 131_072, 8, 128, 8, 1.0, False),
               ("path_100k", 480_000, 8, 64, 8, 0.012, False),
               ("shadow t_max", 524_288, 8, 64, 8, 1.0, True))
PREP_LAUNCHES = 3       # prep_cuda's own launches a call, the sort's aside


def prep_rays(n, live, gen, device):
    """(o, d, t_max) of ``n`` rays: the first ``live`` share from origins
    uniform in the 1000-unit world with cube-uniform unit directions, the
    rest parked at +x from 1e18; t_max uniform in [1, 1000)."""
    import torch
    k = int(round(n * live))
    o = torch.rand((n, 3), generator=gen, device=device) * 1000 - 500
    d = torch.rand((n, 3), generator=gen, device=device) * 2 - 1
    d = d / d.norm(dim=1, keepdim=True)
    o[k:] = 1e18
    d[k:] = torch.tensor([1.0, 0.0, 0.0], device=device)
    return o, d, torch.rand(n, generator=gen, device=device) * 999 + 1


@uncounted()
def prep_check(name, n, S, SP, cell_bits, live, with_t_max, dev):
    """``prep_cuda`` against ``prep_feats_plain`` on the same rays, rows
    (as bits) and dest equal, ``PREP_LAUNCHES`` launches a call, the
    ``prep`` span of ``prep_feats_bucketed`` reading ``prep_kernel`` 1;
    then both
    timed on CUDA events, their device time a call by torch.profiler
    (prep's three kernels and the radix sort's apart), and the bound:
    o, d, perm (and t_max) read once, the rows and dest written once.
    Returns the results row."""
    import torch
    from tracer_torch.bench.profile import profile_calls
    from tracer_torch.bench.timing import time_cuda
    from tracer_torch import trace
    from tracer_torch.kernels import _lib
    from tracer_torch.kernels.leafcull import (prep_cuda, prep_feats_bucketed,
                                               prep_feats_plain)
    gen = torch.Generator(device=dev).manual_seed(23 + n)
    o, d, tm = prep_rays(n, live, gen, dev)
    args = (o, d, S, SP, cell_bits, tm if with_t_max else None)
    before = _lib.launches["prep_cuda"]
    feats, dest = prep_cuda(*args)
    launched = _lib.launches["prep_cuda"] - before
    pfeats, pdest = prep_feats_plain(*args)
    torch.cuda.synchronize()
    if launched != PREP_LAUNCHES:
        raise AssertionError(f"prep {name}: {launched} prep_cuda launches")
    if feats.shape != pfeats.shape:
        raise AssertionError(f"prep {name}: rows {tuple(feats.shape)}, "
                             f"plain {tuple(pfeats.shape)}")
    rows_equal = (feats.view(torch.int32) == pfeats.view(torch.int32)) \
        .reshape(-1, feats.shape[-1]).all(1)
    if not bool(rows_equal.all()) or not torch.equal(dest, pdest):
        raise AssertionError(
            f"prep {name}: prep_cuda differs from the plain version on "
            f"{int((~rows_equal).sum())} of {rows_equal.numel()} rows and "
            f"{int((dest != pdest).sum())} of {n} dest")
    trace.reset()
    with trace.enabled():
        prep_feats_bucketed(*args)
    kernel = [s["counters"].get("prep_kernel") for r in trace.records()
              for s in r["spans"] if s["name"] == "tracer_torch.prep"]
    trace.reset()
    if kernel != [1]:
        raise AssertionError(f"prep {name}: prep spans read prep_kernel "
                             f"{kernel}")
    ms = time_cuda(prep_cuda, *args)
    plain_ms = time_cuda(prep_feats_plain, *args, warmup=1, iters=3)
    kr = profile_calls(prep_cuda, *args, iters=5,
                       names=("prep_", "RadixSort"))
    pr = profile_calls(prep_feats_plain, *args, iters=3)
    perm_bytes = n * 8
    bms, bby = bound(nbytes(o, d, feats, dest) + perm_bytes
                     + (nbytes(tm) if with_t_max else 0), 0)

    def dev_ms(r, key):
        return None if r["shares"] is None else r["shares"][key] \
            * r["window_ms"]
    log(f"prep {name} ({n} rays, S {S} x SP {SP}, cell bits {cell_bits}, "
        f"live {live}, t_max {with_t_max}): rows and dest bit for bit the "
        f"plain version's on {feats.shape[0] * S * SP} slots; "
        f"{launched} prep_cuda launches, the prep span reading prep_kernel "
        f"1; cuda {ms:.4f} ms (events), device "
        f"{fmt_ms(kr['device_ms'])} a call in {kr['launches']} launches "
        f"(prep's kernels {fmt_ms(dev_ms(kr, 'prep_'))}, radix sort "
        f"{fmt_ms(dev_ms(kr, 'RadixSort'))}); plain {plain_ms:.4f} ms "
        f"(events), device {fmt_ms(pr['device_ms'])} in {pr['launches']} "
        f"launches; bound {bms:.4f} ms ({bby})")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bms,
                bound_by=bby, max_abs_err=0, launches=launched,
                device_ms=kr["device_ms"])


def prep_slice(dev, results):
    """Phase 3c: ``prep_cuda`` at each of ``PREP_SHAPES``; the results row
    is query_100k's, with the 10M query's (``*_10m``) and the path frame's
    (``*_path``) beside it."""
    rows = {name: prep_check(name, *shape, dev)
            for name, *shape in PREP_SHAPES}
    results["prep_cuda"] = rows["query_100k"]
    for suffix, name in (("_10m", "query_10m"), ("_path", "path_100k")):
        results["prep_cuda"].update(
            {f"{k}{suffix}": rows[name][k]
             for k in ("ms", "plain_ms", "bound_ms", "device_ms")})


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


# -- bounds ----------------------------------------------------------------

def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by) of work moving n_bytes and doing n_ops."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def walked_leaves(rows, lpg):
    """Leaves each count-embedded row walks, (rows,) int64: the wrappers'
    own count (``leafcull.walked_leaves``)."""
    from tracer_torch.kernels import leafcull
    return leafcull.walked_leaves(rows, lpg).long()


def anyhit_leaves_needed(feats, rows, cull):
    """Leaves the any-hit walk needs per row: up to and including the leaf
    at which every ray of the subpacket is occluded, else all."""
    import torch
    from tracer_torch.kernels.leafcull import anyhit_pairs
    q, occ = anyhit_pairs(*walk_args(feats, rows, cull),
                          pair_elems=PLAIN_ELEMS)
    total = walked_leaves(rows, cull.leaves_per_group)
    start = torch.cumsum(total, 0) - total
    # Rays occluded so far, per pair: a cumulative count within each row.
    cs = torch.cat([torch.zeros_like(occ[:1], dtype=torch.int32),
                    torch.cumsum(occ.to(torch.int32), 0, dtype=torch.int32)])
    i = torch.arange(q.shape[0], device=q.device)
    done = ((cs[i + 1] - cs[start[q]]) > 0).all(dim=1)
    first = torch.full_like(total, q.shape[0])
    first.scatter_reduce_(0, q, torch.where(done, i, q.shape[0]), "amin")
    return torch.where(first < q.shape[0], first - start + 1, total)


def walk_bound(name, feats, rows, cull, leaves, out_bytes, extra=()):
    """Bound of a leaf walk that tests ``leaves`` leaves per row."""
    tests = int(leaves.sum()) * cull.leaf_size * feats.shape[2]
    n_bytes = nbytes(feats, rows, cull.prims, *extra) + out_bytes
    log(f"{name}: {tests} (ray, prim) tests needed, {n_bytes} bytes")
    return bound(n_bytes, tests * OPS_PER_TEST)


def traverse_bound(name, rays, packed, steps, leaves):
    """Bound of a packet walk: steps x 1024 slab tests and leaf visits x
    leaf size x 1024 quadratic tests, for the steps and leaves the plain
    version counted on the same inputs."""
    from tracer_torch.kernels.traverse import PACKET
    slabs = int(steps.sum()) * PACKET
    quads = int(leaves.sum()) * packed.leaf_size * PACKET
    n_bytes = nbytes(rays, packed.nodes, packed.links, packed.prims, steps) \
        + rays.shape[0] * PACKET * 8
    log(f"{name}: {slabs} slab tests, {quads} quadratic tests, "
        f"{n_bytes} bytes")
    return bound(n_bytes, slabs * OPS_PER_SLAB + quads * OPS_PER_BFORM)


def row_lengths(name, walked, unit="listed tiles", group=None):
    """Log the distribution of ``unit`` walked per row: mean, p99, max,
    total; with ``group`` ((rows,) bool), the share of rows in group
    mode."""
    import torch
    c = walked.reshape(-1).float()
    share = ("" if group is None else f", group mode on "
             f"{group.reshape(-1).float().mean().item():.4f} of rows")
    log(f"{name}: {c.numel()} rows, {unit} per row mean "
        f"{c.mean().item():.2f}, p99 {torch.quantile(c, 0.99).item():.0f}, "
        f"max {int(c.max())}, total {int(c.sum())}{share}")


def leaf_rows(name, rows, lpg):
    """Log a leaf walk's rows: walked leaves per row (mean, p99, max,
    total) and the share of rows in group mode."""
    row_lengths(name, walked_leaves(rows, lpg), "walked leaves",
                rows[..., 0] < 0)


def skewed_leaf_rows(C, R, lpc, lpg, gen):
    """(C, R, rowlen) int32 leaf rows: in each chunk the middle row walks
    every group (group mode), every other row lists 1-2 random leaves."""
    import torch
    gpc = lpc // lpg
    rows = torch.zeros((C, R, max(gpc, 2) + 1), dtype=torch.int32)
    rows[..., 0] = torch.randint(1, 3, (C, R), generator=gen,
                                 dtype=torch.int32)
    rows[..., 1:3] = torch.randint(0, lpc, (C, R, 2), generator=gen,
                                   dtype=torch.int32)
    rows[:, R // 2, 0] = -gpc
    rows[:, R // 2, 1:1 + gpc] = torch.arange(gpc, dtype=torch.int32)
    return rows


def skewed_routed_rows(pair_c, S, rowlen, lpc, lpg, gen):
    """(Np, S, rowlen) int32 routed rows for chunk-major pairs ``pair_c``:
    the first row of each chunk's first pair walks every group of the
    chunk (group mode), every other row lists 1-2 random leaves."""
    import torch
    gpc = lpc // lpg
    pc = pair_c.cpu()
    n = pc.shape[0]
    rows = torch.full((n, S, rowlen), lpc, dtype=torch.int32)
    rows[..., 0] = torch.randint(1, 3, (n, S), generator=gen,
                                 dtype=torch.int32)
    rows[..., 1:3] = torch.randint(0, lpc, (n, S, 2), generator=gen,
                                   dtype=torch.int32)
    first = torch.ones(n, dtype=torch.bool)
    first[1:] = pc[1:] != pc[:-1]
    rows[first, 0, 0] = -gpc
    rows[first, 0, 1:1 + gpc] = torch.arange(gpc, dtype=torch.int32)
    rows[first, 0, 1 + gpc:] = gpc
    return rows.to(pair_c.device)


def skewed_lists(rows, T, gen):
    """(rows, T) int32 lists and (rows,) counts: the middle row lists every
    tile 0..T-1, every other row 1-2 random tiles (then the sentinel T)."""
    import torch
    lists = torch.full((rows, T), T, dtype=torch.int32)
    counts = torch.randint(1, 3, (rows,), generator=gen, dtype=torch.int32)
    lists[:, :2] = torch.randint(0, T, (rows, 2), generator=gen,
                                 dtype=torch.int32)
    lists[:, 1] = torch.where(counts > 1, lists[:, 1], T)
    lists[rows // 2] = torch.arange(T, dtype=torch.int32)
    counts[rows // 2] = T
    return lists, counts


def tilecull_bound(name, feats, cand, prims):
    """Bound of a tile walk: sum of counts x 128 x 128 tests."""
    from tracer_torch.kernels.tilecull import SUBPACKET
    tests = int(cand[..., 0].sum()) * SUBPACKET * 128
    n_bytes = nbytes(feats, cand, prims) + feats[..., 0].numel() * 8
    log(f"{name}: {tests} (ray, prim) tests, {n_bytes} bytes")
    return bound(n_bytes, tests * OPS_PER_TILE_TEST)


def compare_traverse(name, rays, packed):
    """traverse_cuda vs traverse_plain: t, slots and steps equal exactly.
    Returns the plain version's (steps, leaf visits)."""
    import torch
    from tracer_torch.kernels.traverse import traverse_cuda, traverse_plain
    tk, sk, stk = traverse_cuda(rays, packed)
    tp, sp, stp, leaves = traverse_plain(rays, packed, leaf_visits=True)
    torch.cuda.synchronize()
    if not (torch.equal(sk, sp) and torch.equal(tk, tp)
            and torch.equal(stk, stp)):
        raise AssertionError(f"{name}: traverse_cuda != plain on "
                             f"{int((sk != sp).sum())} slot(s), "
                             f"{int((tk != tp).sum())} t value(s), "
                             f"{int((stk != stp).sum())} step count(s)")
    log(f"{name}: {rays.shape[0]} packets, {int((sk >= 0).sum())} hits, "
        f"steps {int(stp.min())}-{int(stp.max())} (sum {int(stp.sum())}), "
        f"{int(leaves.sum())} leaf visits; t, slots, steps equal bit for "
        f"bit")
    return stp, leaves


def packet_steps(name, steps):
    """Log a packet walk's steps per packet: mean, p99, max, sum and the
    packets over LONG_WALK steps."""
    import torch
    c = steps.float()
    log(f"{name}: {c.numel()} packets, steps per packet mean "
        f"{c.mean().item():.2f}, p99 {torch.quantile(c, 0.99).item():.0f}, "
        f"max {int(c.max())}, sum {int(c.sum())}, "
        f"{int((steps > LONG_WALK).sum())} over {LONG_WALK}")


def divergent_rays(n_packets, tail, world, gen, device):
    """(origins, directions) of n_packets packets and a ragged tail of the
    kind compaction leaves on a late bounce: packet 0 all live rays, with
    origins spread through the scene and random directions, packet 1 half
    live, the rest parked as the integrator parks finished rays (origin
    1e18, direction +x), the tail live."""
    import torch
    from tracer_torch.kernels.traverse import PACKET
    b = n_packets * PACKET + tail
    o = torch.full((b, 3), 1e18)
    d = torch.zeros((b, 3))
    d[:, 0] = 1.0
    live = torch.zeros(b, dtype=torch.bool)
    live[:PACKET] = True
    live[PACKET:2 * PACKET:2] = True
    live[n_packets * PACKET:] = True
    n = int(live.sum())
    o[live] = (torch.rand((n, 3), generator=gen) - 0.5) * world
    dl = torch.randn((n, 3), generator=gen)
    d[live] = dl / dl.norm(dim=1, keepdim=True)
    return o.to(device), d.to(device)


def compare_tilecull(name, feats, cand, prims):
    """tilecull_cuda vs tilecull_plain: t and slots equal exactly."""
    import torch
    from tracer_torch.kernels.tilecull import tilecull_cuda, tilecull_plain
    tk, sk = tilecull_cuda(feats, cand, prims)
    tp, sp = tilecull_plain(feats, cand, prims, pair_elems=PLAIN_ELEMS)
    torch.cuda.synchronize()
    if not (torch.equal(sk, sp) and torch.equal(tk, tp)):
        raise AssertionError(f"{name}: tilecull_cuda != plain on "
                             f"{int((sk != sp).sum())} slot(s), "
                             f"{int((tk != tp).sum())} t value(s)")
    log(f"{name}: {feats.shape[0] * feats.shape[1]} subpackets, "
        f"{int(cand[..., 0].sum())} listed tiles, "
        f"{int((sk < 2 ** 30).sum())} hits; t and slots equal bit for bit")


def tile_rows(o, d, table, k, subpackets, escalate=False):
    """Tile rows of rays in order (padded like the wrapper); with
    ``escalate`` the budget doubles until nothing overflows, as the checked
    driver does. Returns (feats, rows, overflow, budget)."""
    from tracer_torch.kernels.leafcull import _pad_edge
    from tracer_torch.kernels.tilecull import (pack_ray_features,
                                               subpacket_candidates)
    feats, _, pad = pack_ray_features(o, d, subpackets)
    while True:
        cand, ovf = subpacket_candidates(_pad_edge(o, pad), _pad_edge(d, pad),
                                         table, k, subpackets)
        if not (escalate and bool(ovf)) or k >= table.num_tiles:
            return feats, cand, bool(ovf), k
        k = min(2 * k, -(-table.num_tiles // 128) * 128)


def wrapper_ids_match(name, rec, ids, o, d, scene):
    """A wrapper's HitRecord on a 2-D batch against the plain walk's sphere
    ids on the same rays, flattened. The wrapper recomputes t with the
    reference quadratic (``ray_sphere_t``), which rounds differently from
    either walk; where it finds no root at a graze the record is a miss.
    Those rays, and only those, may differ."""
    import torch
    from tracer_torch.intersect.sphere import ray_sphere_t
    got = rec.index.reshape(-1)
    diff = got != ids
    s = ids[diff].clamp(min=0).long()
    t = ray_sphere_t(o[diff], d[diff], scene.centers[s], scene.radii[s])
    dropped = (got[diff] == -1) & (ids[diff] >= 0) & torch.isinf(t)
    log(f"{name} 2-D batch {tuple(rec.index.shape)}: ids equal the plain "
        f"walk's on {int((~diff).sum())} rays; {int(diff.sum())} differ, "
        f"{int(dropped.sum())} of them grazes the reference quadratic drops")
    if not bool(dropped.all()):
        raise AssertionError(f"{name}: 2-D wrapper != plain walk")


def cones_of(feats, tables):
    """The subpackets' cones (G, S, CONE_FEAT), as the phase-B path builds
    them."""
    from tracer_torch.kernels.conecull import (CONE_FEAT, bounds_from_feats,
                                               cone_from_feats)
    cones = cone_from_feats(feats, *bounds_from_feats(feats), tables.r_max)
    return cones.reshape(*feats.shape[:2], CONE_FEAT)


def skewed_leaf_walks(dev):
    """Phase 3b, skewed rows: leafcull_cuda, anyhit_cuda and conecull_cuda
    vs their plain versions at SP = 64 and 128, 20k spheres x 64k rays in
    C > 1 chunks of the dense scene (so that 1-2 random leaves give hits):
    in each chunk one row walks every group (group mode), the others list
    1-2 leaves."""
    import torch
    from tracer_torch.bench import headline
    from tracer_torch.kernels.leafcull import prep_feats_bucketed
    _, tables, o, d, _ = headline.benchmark_inputs(
        dev, n_spheres=WALK_SPHERES, n_rays=WALK_RAYS, world=40.0,
        max_chunk_bytes=256 << 10)
    cull = tables.cull
    C, lpc, lpg = cull.num_chunks, cull.leaves_per_chunk, cull.leaves_per_group
    if C < 2:
        raise AssertionError("small max_chunk_bytes kept one chunk")
    gen = torch.Generator().manual_seed(13)
    tm = torch.full((o.shape[0],), SMALL_T_MAX, device=dev)
    for sp in (64, 128):
        feats = prep_feats_bucketed(o, d, headline.S, sp,
                                    cell_bits=headline.CELL_BITS, t_max=tm)[0]
        G, S = feats.shape[:2]
        rows = skewed_leaf_rows(C, G * S, lpc, lpg, gen)
        rows = rows.reshape(C, G, S, -1).to(dev)
        name = (f"skewed leaf rows, SP {sp}, {C} chunks (one row a chunk "
                f"walks all {lpc // lpg} groups)")
        leaf_rows(name, rows, lpg)
        compare_walk(f"walk, {name}", feats, rows, cull)
        compare_anyhit(f"any-hit, {name}", feats, rows, cull)
        compare_conecull(f"phase B, {name}", feats, rows,
                         cones_of(feats, tables), cull)


def packet_and_tile_walks(dev):
    """Phase 3c: traverse_cuda and tilecull_cuda vs their plain versions at
    20k spheres x 64k origin rays (octahedral-sorted), 16-prim leaves."""
    import torch
    from tracer_torch.bench import headline
    from tracer_torch.bvh.builder import build_bvh
    from tracer_torch.core.sort import octahedral_codes
    from tracer_torch.core.types import Ray
    from tracer_torch.intersect.cull import build_leaf_table
    from tracer_torch.kernels.tilecull import (_NOSLOT, nearest_hit_tilecull,
                                               pack_prim_tiles,
                                               tilecull_plain)
    from tracer_torch.kernels.traverse import (nearest_hit_bvh_packets,
                                               pack_bvh, pack_rays,
                                               traverse_plain)
    scene, _, o, d, _ = headline.benchmark_inputs(
        dev, n_spheres=WALK_SPHERES, n_rays=WALK_RAYS, world=500.0)
    perm = torch.argsort(octahedral_codes(d), stable=True)
    o, d = o[perm], d[perm]
    bvh = build_bvh(scene.centers, scene.radii, leaf_size=16,
                    backend="native", device=dev)
    packed = pack_bvh(scene, bvh)
    table = build_leaf_table(bvh)
    prims = pack_prim_tiles(packed)

    n = o.shape[0] - 300                                   # ragged tail
    rays, g, pad = pack_rays(o[:n], d[:n])
    compare_traverse(f"packet walk {WALK_SPHERES} x {n} ({g} packets, "
                     f"{pad} padding rays)", rays, packed)
    # Divergent packets: one spans the scene beside parked rays.
    od, dd = divergent_rays(8, 300, 500.0, torch.Generator().manual_seed(14),
                            dev)
    drays, dg, _ = pack_rays(od, dd)
    name = (f"divergent packet walk {WALK_SPHERES} x {od.shape[0]} ({dg} "
            f"packets)")
    steps, _ = compare_traverse(name, drays, packed)
    packet_steps(name, steps)
    # A 2-D batch through the wrapper, against the plain walk's slots.
    o2, d2 = o.reshape(-1, 256, 3), d.reshape(-1, 256, 3)
    rec, steps = nearest_hit_bvh_packets(Ray(o2, d2), scene, packed,
                                         with_steps=True)
    _, sp, stp = traverse_plain(pack_rays(o, d)[0], packed)
    sp = sp.reshape(-1)[:o.shape[0]]
    ids = torch.where(sp >= 0, packed.prim_idx[sp.clamp(min=0).long()], -1)
    if not torch.equal(steps.reshape(-1),
                       stp.repeat_interleave(1024)[:o.shape[0]]):
        raise AssertionError("packet walk: 2-D wrapper steps != plain walk")
    wrapper_ids_match("packet walk", rec, ids, o, d, scene)

    feats, cand, ovf, _ = tile_rows(o[:n], d[:n], table, 64, 8)
    compare_tilecull(f"tile walk {WALK_SPHERES} x {n}, budget 64 "
                     f"(overflow {ovf})", feats, cand, prims)
    feats1, cand1, ovf1, _ = tile_rows(o[:n], d[:n], table, 1, 8)
    if not ovf1:
        raise AssertionError("a tile budget of one did not overflow")
    compare_tilecull(f"tile walk {WALK_SPHERES} x {n}, budget 1 "
                     f"(overflowing rows)", feats1, cand1, prims)
    # Rows that list the sentinel tile T after their own tiles.
    T = table.num_tiles
    cnt = cand[..., 0]
    room = cnt + 1 < cand.shape[-1]
    cs = cand.clone()
    col = (cnt + 1).clamp(max=cand.shape[-1] - 1).long()[..., None]
    cs.scatter_(2, col, torch.where(room[..., None], T, cs.gather(2, col)))
    cs[..., 0] = torch.where(room, cnt + 1, cnt)
    compare_tilecull(f"tile walk {WALK_SPHERES} x {n}, sentinel tile listed "
                     f"({int(room.sum())} rows)", feats, cs, prims)
    # Skewed rows: one lists every tile, the others 1-2.
    lists, counts = skewed_lists(feats.shape[0] * feats.shape[1], T,
                                 torch.Generator().manual_seed(11))
    kp = -(-(T + 1) // 128) * 128
    skew = torch.full((lists.shape[0], kp), T, dtype=torch.int32)
    skew[:, 0], skew[:, 1:T + 1] = counts, lists
    compare_tilecull(f"tile walk {WALK_SPHERES} x {n}, skewed rows (one "
                     f"lists all {T} tiles)", feats,
                     skew.reshape(*feats.shape[:2], kp).to(dev), prims)
    t0, s0 = tilecull_plain(feats, cand, prims, pair_elems=PLAIN_ELEMS)
    t1, s1 = tilecull_plain(feats, cs, prims, pair_elems=PLAIN_ELEMS)
    if not (torch.equal(s0, s1) and torch.equal(t0, t1)):
        raise AssertionError("the sentinel tile changed a result")
    rec2, ovf2 = nearest_hit_tilecull(Ray(o2, d2), scene, packed, table,
                                      max_candidates=T)
    feats_all, cand_all, _, _ = tile_rows(o, d, table, T, 8)
    _, sa = tilecull_plain(feats_all, cand_all, prims, pair_elems=PLAIN_ELEMS)
    sa = sa.permute(0, 2, 1).reshape(-1)[:o.shape[0]]
    ida = torch.where(sa < _NOSLOT, packed.prim_idx[
        torch.where(sa < _NOSLOT, sa, 0).long()], -1)
    if bool(ovf2):
        raise AssertionError("tile walk: the full budget overflowed")
    wrapper_ids_match("tile walk", rec2, ida, o, d, scene)


def epilogue_ids(o, d, ids, scene):
    """Sphere ids after the renderer's epilogue: t recomputed with the
    reference quadratic, -1 where it finds no root."""
    from tracer_torch.intersect.brute import record_from_ids
    return record_from_ids(o, d, ids, scene).index


def bform_brute_ids(o, d, scene, block=1024):
    """Sphere ids of a b-form brute force over every sphere (the packet
    walk's and the packet cull's rounding; their two spellings differ by
    exact powers of two), lowest id among equal t, through the wrappers'
    epilogue."""
    import torch
    from tracer_torch.kernels.traverse import _bform_t, _ray_terms
    ro, rd, _, a, inv2a = _ray_terms(torch.cat([o, d, o[:, :2] * 0], 1))
    terms = [x[:, None] for x in (*ro, *rd, a, inv2a)]
    c, rsq = scene.centers, scene.radii * scene.radii
    ids = []
    for i in range(0, o.shape[0], block):
        t = _bform_t(*(x[i:i + block] for x in terms), c[:, 0], c[:, 1],
                     c[:, 2], rsq)
        tm, j = t.min(1)                       # lowest id among equal t
        ids.append(torch.where(torch.isfinite(tm), j, -1).to(torch.int32))
    return epilogue_ids(o, d, torch.cat(ids), scene)


def sphere_of_in(sc):
    """Choice -> (centre, |c|^2 - r^2) of sphere ids in scene ``sc``."""
    def sphere_of(s):
        s = s.clamp(min=0).long()
        c = sc.centers[s]
        return c, (c * c).sum(-1) - sc.radii[s] * sc.radii[s]
    return sphere_of


def ref_t_of(o, d, scene):
    """Sphere ids -> t of the reference quadratic (+inf for -1)."""
    import torch
    from tracer_torch.intersect.sphere import ray_sphere_t

    def t_of(ids):
        s = ids.clamp(min=0).long()
        t = ray_sphere_t(o, d, scene.centers[s], scene.radii[s])
        return torch.where(ids >= 0, t, torch.full_like(t, float("inf")))
    return t_of


class Compactions:
    """The compactor's calls on the main paths: recorded while a path runs
    (``record``), then held equal to the plain version, timed, logged per
    path and dropped as soon as the path's counts are read (``check``)."""

    def __init__(self, base=None):
        self.base = base    # another compactor, held equal and timed beside
        self.calls = []     # (plane, sentinel, keep) since the last check
        self.paths = {}     # path -> tracer_torch.bench.compact.report's row

    def record(self):
        from tracer_torch.bench.compact import recording
        return recording(self.calls)

    def check(self, name, timed=0):
        """compact_cuda vs its plain version, exactly, on every plane the
        path ``name`` gave it; the first ``timed`` planes timed, one per
        shape (``time_compactor``); the path's launches, (P, M, keep)
        shapes and summed device time logged (bench.compact.report); the
        planes dropped. The launches made here are not the path's: they
        are not counted."""
        import torch
        from tracer_torch.bench.compact import report
        from tracer_torch.kernels.conecull import (
            compact_ascending_rows_plain, compact_cuda)
        calls, self.calls = self.calls, []
        with uncounted():
            for ids, sentinel, keep in calls:
                ok, ck = compact_cuda(ids, sentinel, keep)
                op, cp = compact_ascending_rows_plain(ids, sentinel, keep)
                torch.cuda.synchronize()
                if not (torch.equal(ok, op) and torch.equal(ck, cp)):
                    raise AssertionError(f"{name}: compact_cuda != plain on "
                                         f"a {tuple(ids.shape)} plane")
            seen = set()
            for call in calls[:timed]:
                shape = tuple(call[0].shape)
                if shape not in seen:
                    seen.add(shape)
                    ragged = " (ragged)" if shape[1] % 4 else ""
                    time_compactor(f"compact, {name} {shape}{ragged}", *call)
            self.paths.update(report({name: calls}, self.base, log))
        del calls
        torch.cuda.empty_cache()

    def summary(self):
        """Phase 7b: the compactor over every main path."""
        rows = self.paths.values()
        total = {k: sum(r[k] for r in rows) for k in
                 ("launches", "bound_ms", "device_ms")
                 + (("baseline_ms",) if self.base else ())}
        log(f"compact_cuda equal to its plain version on all "
            f"{total['launches']} planes of {len(self.paths)} paths; "
            f"every path: {total}")


def kernel_ms(fn, args, name, tries=3):
    """Device time per call of the kernels whose name holds ``name`` in
    ``fn(*args)``, by torch.profiler; None where it saw no device time in
    ``tries`` profiled windows (a window now and then comes back empty)."""
    from tracer_torch.bench.profile import profile_calls
    for _ in range(tries):
        r = profile_calls(fn, *args, iters=5, names=(name,))
        if r["shares"] is not None and r["shares"][name] > 0:
            return r["shares"][name] * r["window_ms"]
    return None


def fmt_ms(v):
    return "not measured" if v is None else f"{v:.4f} ms"


@contextlib.contextmanager
def recording(module, fn_name, into):
    """Within the block, calls of ``module.fn_name`` run unchanged and
    their arguments are appended to ``into``; with no module, nothing."""
    if module is None:
        yield
        return
    real = getattr(module, fn_name)

    def record(*a):
        into.append(a)
        return real(*a)
    setattr(module, fn_name, record)
    try:
        yield
    finally:
        setattr(module, fn_name, real)


def frame_walks(captured):
    """The render slice's walks on the arguments the frames gave them:
    each leaf walk of the path/auto frame (its rows, time and bound; one
    a bounce, at the budgets its escalation settled on), the direct/auto
    frame's any-hit walk, and the
    path/pallas frame's packet walks (each bounce against its plain
    version, its steps per packet, time, time per step of its longest
    packet and bound; then the split's sweep over the five) and the
    direct/pallas frame's against its plain version."""
    import types
    from tracer_torch.bench.timing import time_cuda
    from tracer_torch.kernels.leafcull import anyhit_cuda, leafcull_cuda
    from tracer_torch.kernels.traverse import traverse_cuda

    def tables(a):
        return types.SimpleNamespace(prims=a[2], leaf_size=a[3],
                                     leaves_per_chunk=a[4],
                                     leaves_per_group=a[5])

    calls = captured["leafcull"]
    total_ms = total_bound = 0.0
    heaviest = None
    for i, a in enumerate(calls):
        feats, rows = a[0], a[1]
        name = f"path/auto leaf walk {i}"
        leaf_rows(f"{name} rows", rows, a[5])
        ms = time_cuda(leafcull_cuda, *a)
        walked = walked_leaves(rows, a[5])
        bms, bby = walk_bound(name, feats, rows, tables(a), walked,
                              rows[..., 0].numel() * feats.shape[2] * 8)
        log(f"{name}: cuda {ms:.4f} ms, bound {bms:.4f} ms ({bby})")
        total_ms, total_bound = total_ms + ms, total_bound + bms
        if heaviest is None or int(walked.sum()) > heaviest[0]:
            heaviest = (int(walked.sum()), i)
    log(f"path/auto frame: {len(calls)} leafcull_cuda launches, {total_ms:.4f}"
        f" ms in all, bound {total_bound:.4f} ms")
    if heaviest is not None:
        a = calls[heaviest[1]]
        compare_walk(f"path/auto leaf walk {heaviest[1]}", a[0], a[1],
                     tables(a))

    for a in captured["anyhit"]:
        sfeats, srows = a[0], a[1]
        leaf_rows("direct/auto any-hit walk rows", srows, a[5])
        compare_anyhit("direct/auto any-hit walk", sfeats, srows, tables(a))
        ms = time_cuda(anyhit_cuda, *a)
        bms, bby = walk_bound("direct/auto any-hit walk", sfeats, srows,
                              tables(a), anyhit_leaves_needed(sfeats, srows,
                                                              tables(a)),
                              sfeats[..., 0].numel() * 4)
        log(f"direct/auto any-hit walk: cuda {ms:.4f} ms, bound {bms:.4f} ms"
            f" ({bby})")

    calls = captured["traverse"]
    total_ms = total_bound = 0.0
    for i, (rays, packed) in enumerate(calls):
        name = f"path/pallas packet walk, bounce {i}"
        steps, leaves = compare_traverse(name, rays, packed)
        packet_steps(name, steps)
        ms = time_cuda(traverse_cuda, rays, packed)
        bms, bby = traverse_bound(name, rays, packed, steps, leaves)
        log(f"{name}: cuda {ms:.4f} ms, {ms * 1e3 / int(steps.max()):.4f} us"
            f" per step of the longest packet, bound {bms:.4f} ms ({bby})")
        total_ms, total_bound = total_ms + ms, total_bound + bms
    log(f"path/pallas frame: {len(calls)} traverse_cuda launches, "
        f"{total_ms:.4f} ms in all, bound {total_bound:.4f} ms")
    for rays, packed in captured["traverse_direct"]:
        compare_traverse("direct/pallas packet walk (primary rays)", rays,
                         packed)
    for v in captured.values():
        v.clear()


def render_slice(dev, results, comp):
    """Phase 7: the renderer at full size through the CLI's code path; the
    compactor's planes of each frame recorded and checked (``comp``, a
    Compactions)."""
    import torch
    from tracer_torch import cli
    from tracer_torch.bench import render as brender
    from tracer_torch.core.types import Ray
    from tracer_torch.intersect.brute import nearest_hit_brute_fast
    from tracer_torch.integrator.wavefront import bounce_noise
    from tracer_torch.kernels import _lib
    from tracer_torch.kernels.tilecull import (pack_prim_tiles, tilecull_cuda,
                                               tilecull_plain)
    from tracer_torch.kernels.traverse import (pack_rays, traverse_cuda,
                                               traverse_plain)
    from tracer_torch.bench.timing import time_cuda
    from tracer_torch.scene.camera import camera_rays
    counted = ("traverse_cuda", "tilecull_cuda", "leafcull_cuda",
               "compact_cuda", "anyhit_cuda")

    from tracer_torch.kernels import conecull as kcone, traverse as ktrav
    # The walks' arguments as the frames ran them: every leaf walk of the
    # path/auto frame, the any-hit walk of the direct/auto frame and every
    # packet walk of the two pallas frames.
    captured = {"leafcull": [], "anyhit": [], "traverse": [],
                "traverse_direct": []}
    hooks = {("path", "auto"): (kcone, "leafcull_call", "leafcull"),
             ("direct", "auto"): (kcone, "anyhit_call", "anyhit"),
             ("path", "pallas"): (ktrav, "traverse_call", "traverse"),
             ("direct", "pallas"): (ktrav, "traverse_call",
                                    "traverse_direct")}
    sessions, images = {}, {}
    for mode in brender.MODES:
        for impl in brender.IMPLS:
            sessions[mode, impl] = cli.prepare(cli.build_parser().parse_args(
                brender.argv(mode, impl) + ["--frames", str(RENDER_FRAMES)]))
    s0 = sessions["path", "auto"]
    cfg = s0.config
    noise = bounce_noise(torch.Generator(device=dev).manual_seed(1),
                         (cfg.height, cfg.width), cfg.max_depth, dev)
    start = _lib.launches.copy()
    per = {}
    for key, sess in sessions.items():
        before = _lib.launches.copy()
        module, fn, walk = hooks.get(key, (None, None, None))
        with recording(module, fn, captured.get(walk)), comp.record():
            images[key] = sess.frame(sess.camera, noise)
        torch.cuda.synchronize()
        per[key] = launches_since(before, *counted)
        comp.check(f"render {key[0]}/{key[1]}",
                   timed=1 if key == ("path", "tilecull") else 0)
    launches = launches_since(start, *counted)
    log(f"render slice launches: {launches}")
    for key, n in per.items():
        log(f"  {key}: {n}; escalations {sessions[key].counts}")
    if min(launches.values()) < 1:
        raise AssertionError("the render slice did not run every kernel")
    for key, img in images.items():
        if not (tuple(img.shape) == (cfg.height, cfg.width, 3)
                and bool(torch.isfinite(img).all())):
            raise AssertionError(f"render {key}: bad image")

    def agree(a, b):
        return ((images[a] - images[b]).abs() <= PIXEL_ATOL).all(-1) \
            .float().mean().item()

    for mode in ("path", "direct"):
        same = agree((mode, "auto"), (mode, "tilecull"))
        other = agree((mode, "auto"), (mode, "pallas"))
        log(f"render {mode}: auto vs tilecull agree on {same:.6f} of pixels,"
            f" auto vs pallas on {other:.6f}")
        if same < MIN_AGREE or other < MIN_AGREE_OTHER_ROUNDING:
            raise AssertionError(f"render {mode}: images disagree")

    # Primary ids against brute force on the first BRUTE_RAYS camera rays.
    scene = s0.scene
    rays = camera_rays(s0.camera, cfg)
    o = rays.origin.reshape(-1, 3)[:BRUTE_RAYS].contiguous()
    d = rays.direction.reshape(-1, 3)[:BRUTE_RAYS].contiguous()
    # brute_t_fast's ids through the renderer's epilogue (t recomputed with
    # the reference quadratic): nearest_hit_brute_fast.
    ib = nearest_hit_brute_fast(Ray(o, d), scene, block=1024).index
    # The packet walk's own rounding: the b-form over every sphere.
    ib_b = bform_brute_ids(o, d, scene)
    sphere_of, t_of = sphere_of_in(scene), ref_t_of(o, d, scene)

    check_choices("b-form vs oc-form brute force (first 16k primary rays)",
                  o, d, sphere_of, t_of(ib_b), ib_b, t_of(ib), ib, -1,
                  MIN_AGREE_OTHER_ROUNDING)
    for impl in brender.IMPLS:
        rec = sessions["path", impl].nearest(scene)(Ray(o, d))
        ids = rec.index.reshape(-1)
        if impl == "pallas":
            check_choices("primary ids, pallas vs b-form brute", o, d,
                          sphere_of, rec.t, ids, t_of(ib_b), ib_b, -1)
        check_choices(f"primary ids, {impl} vs nearest_hit_brute_fast", o,
                      d, sphere_of, rec.t, ids, t_of(ib), ib, -1,
                      MIN_AGREE if impl != "pallas"
                      else MIN_AGREE_OTHER_ROUNDING)

    # The two new kernels vs their plain versions on the frame's primary
    # rays, timed there.
    of, df = rays.origin.reshape(-1, 3), rays.direction.reshape(-1, 3)
    packed = sessions["path", "pallas"].tables["packed"]
    prays, g, _ = pack_rays(of, df)
    steps, leaves = compare_traverse(f"packet walk, primary rays of the "
                                     f"frame ({g} packets)", prays, packed)
    ms = time_cuda(traverse_cuda, prays, packed)
    pms = time_cuda(traverse_plain, prays, packed, warmup=0, iters=1)
    bms, bby = traverse_bound("packet walk, frame", prays, packed, steps,
                              leaves)
    log(f"packet walk frame: cuda {ms:.4f} ms, plain {pms:.4f} ms, bound "
        f"{bms:.4f} ms ({bby})")
    results["traverse_cuda"] = dict(
        ms=ms, plain_ms=pms, library_ms=None, bound_ms=bms, bound_by=bby,
        max_abs_err=0, launches=launches["traverse_cuda"])
    ts = sessions["path", "tilecull"]
    table = ts.tables["leaf_table"]
    tiles = pack_prim_tiles(ts.tables["packed"])
    feats, cand, _, k = tile_rows(of, df, table,
                                  min(128, table.num_tiles), 8,
                                  escalate=True)
    compare_tilecull(f"tile walk, primary rays of the frame (budget {k})",
                     feats, cand, tiles)
    row_lengths("tile walk frame rows", cand[..., 0])
    ms = time_cuda(tilecull_cuda, feats, cand, tiles)
    pms = time_cuda(lambda *a: tilecull_plain(*a, pair_elems=PLAIN_ELEMS),
                    feats, cand, tiles, warmup=0, iters=1)
    bms, bby = tilecull_bound("tile walk, frame", feats, cand, tiles)
    log(f"tile walk frame: cuda {ms:.4f} ms, plain {pms:.4f} ms, bound "
        f"{bms:.4f} ms ({bby})")
    results["tilecull_cuda"] = dict(
        ms=ms, plain_ms=pms, library_ms=None, bound_ms=bms, bound_by=bby,
        max_abs_err=0, launches=launches["tilecull_cuda"])
    frame_walks(captured)

    # One metrics line per (mode, impl): the CLI's timed frame loop.
    for key, sess in sessions.items():
        _, times = cli.render_frames(sess, lambda i: noise)
        log(json.dumps(cli.metrics(sess, times)))


def phase_a(feats, tables, mg=None, mc=None):
    """Phase A of the leaf and cone walks at the bench budgets (or the
    given ones): (rows (C, G, S, rowlen), cones (G, S, CONE_FEAT))."""
    from tracer_torch.bench import headline
    from tracer_torch.kernels.conecull import cone_candidates
    rows, _, _ = cone_candidates(feats, tables, mg or headline.MG,
                                 mc or headline.MC)
    G, S = feats.shape[:2]
    return (rows.reshape(tables.cull.num_chunks, G, S, rows.shape[-1]),
            cones_of(feats, tables))


def phase_a_plain(bounds, tables, S, budgets, pairs=()):
    """The torch operations ``phase_a_cuda`` replaces, on its arguments:
    ``candidate_rows`` (no pairs: every chunk's rows, chunk-major) or
    ``tlas._pair_block_rows``. Returns (rows (nrows, rowlen), overflow)."""
    from tracer_torch.kernels.conecull import candidate_rows
    from tracer_torch.kernels.tlas import _pair_block_rows
    k0, k, kg, keep_l, gkeep, rowlen = budgets
    cull = tables.cull
    if not pairs:
        rows, ovf = candidate_rows(tuple(bounds[:, i:i + 3]
                                         for i in range(0, 12, 3)), cull,
                                   tables.leaf_boxes, k0, k, rowlen,
                                   exact=False)
        return rows.reshape(-1, rowlen), ovf
    C, gpc = cull.num_chunks, cull.leaves_per_chunk // cull.leaves_per_group
    rows, ovf = _pair_block_rows(
        bounds.reshape(-1, S * 12), cull.group_min.reshape(C, gpc, 3),
        cull.group_max.reshape(C, gpc, 3), tables, *pairs, S, k0, gkeep, k,
        kg, keep_l, rowlen)
    return rows.reshape(-1, rowlen), ovf


def phase_a_tests(bounds, tables, S, k0, pairs=()):
    """(group-box tests, leaf-box tests) the rows need: every group of a
    row's chunk (of active rows; without pairs, of every chunk), and the
    member leaves of its first groups where it has at most k0."""
    import torch
    from tracer_torch.kernels.conecull import _slab_hit_cols
    cull = tables.cull
    lpg = cull.leaves_per_group
    gpc = cull.leaves_per_chunk // lpg
    b = tuple(bounds[:, i:i + 3] for i in range(0, 12, 3))
    g = torch.arange(gpc if pairs else cull.num_groups, device=bounds.device)
    if pairs:
        pc, pg, act = (x.long() for x in pairs)
        q = (pg[:, None] * S + torch.arange(S, device=bounds.device)) \
            .reshape(-1)
        chunk = pc.repeat_interleave(S)
        b = tuple(x[q] for x in b)
        live = act.repeat_interleave(S).bool()
    else:
        chunk = torch.zeros(bounds.shape[0], dtype=torch.long,
                            device=bounds.device)
        live = torch.ones_like(chunk, dtype=torch.bool)
    counts = []
    for i in range(0, chunk.shape[0], 8192):
        ids = chunk[i:i + 8192, None] * gpc + g
        hit = _slab_hit_cols(*(x[i:i + 8192] for x in b),
                             tuple(cull.group_min[ids, a] for a in range(3)),
                             tuple(cull.group_max[ids, a] for a in range(3)))
        counts.append((hit & (ids * lpg < cull.num_real_leaves)).sum(1))
    gtotal = torch.cat(counts)
    refined = torch.where(live & (gtotal <= k0), gtotal, 0)
    return int(live.sum()) * g.shape[0], int(refined.sum()) * lpg


@uncounted()
def phase_a_check(name, bounds, tables, S, budgets, pairs=(), timed=True):
    """``phase_a_cuda`` against :func:`phase_a_plain` on the same
    arguments, rows and overflow flag bit for bit; with ``timed`` the
    kernel's device time (CUDA graph), the plain version's (events) and
    the kernel's bound logged. Returns the results row."""
    import torch
    from tracer_torch.bench.timing import time_cuda, time_graph
    from tracer_torch.kernels.conecull import phase_a_cuda
    rows, ovf = phase_a_cuda(bounds, tables, S, *budgets, *pairs)
    prow, povf = phase_a_plain(bounds, tables, S, budgets, pairs)
    torch.cuda.synchronize()
    if not torch.equal(rows, prow) or bool(ovf) != bool(povf):
        bad = int((rows != prow).any(dim=1).sum())
        raise AssertionError(f"{name}: phase_a_cuda differs from the plain "
                             f"version on {bad} of {rows.shape[0]} rows "
                             f"(overflow {bool(ovf)}, plain {bool(povf)})")
    cnt = rows[:, 0]
    msg = (f"{name}: phase_a_cuda equal to the plain version on "
           f"{rows.shape[0]} rows x {rows.shape[1]}, group rows "
           f"{int((cnt < 0).sum())}, overflow {bool(ovf)}")
    out = {"max_abs_err": 0, "library_ms": None}
    if timed:
        ms = time_graph(phase_a_cuda, bounds, tables, S, *budgets, *pairs)
        plain_ms = time_cuda(phase_a_plain, bounds, tables, S, budgets,
                             pairs, warmup=1, iters=3)
        n_g, n_l = phase_a_tests(bounds, tables, S, budgets[0], pairs)
        cull = tables.cull
        bms, bby = bound(nbytes(rows, bounds, cull.group_min, cull.group_max,
                                tables.leaf_boxes, *pairs),
                         (n_g + n_l) * OPS_PER_BOX)
        msg += (f"; kernel {ms:.4f} ms (device, graph), plain "
                f"{plain_ms:.4f} ms (events), bound {bms:.4f} ms ({bby}: "
                f"{n_g} group and {n_l} leaf box tests)")
        out.update(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bby)
    log(msg)
    return out


@uncounted()
def phase_a_calls(name, frame, tables):
    """One frame (``frame()``) with ``cone_candidates``' calls recorded and
    the trace on; each call must launch ``phase_a_cuda`` once, and each
    ``phase_a`` span read ``phase_a_kernel`` 1; each of the frame's preps
    must launch ``prep_cuda`` ``PREP_LAUNCHES`` times, and each ``prep``
    span read ``prep_kernel`` 1; the kernel held to the
    torch operations, rows and flag bit for bit, on every call's bounds
    at that call's budgets. Returns each bounce's feature planes (its
    first call, at the render's budgets) and those budgets."""
    import torch
    from tracer_torch import trace
    from tracer_torch.kernels import _lib, conecull as kcone
    from tracer_torch.kernels.conecull import bounds_from_feats, cone_budgets
    cull = tables.cull
    calls = []
    before = _lib.launches.copy()
    trace.reset()
    with recording(kcone, "cone_candidates", calls), trace.enabled():
        frame()
    torch.cuda.synchronize()
    spans = [s for r in trace.records() for s in r["spans"]]
    kernel = [s["counters"].get("phase_a_kernel") for s in spans
              if s["name"] == "tracer_torch.phase_a"]
    prep = [s["counters"].get("prep_kernel") for s in spans
            if s["name"] == "tracer_torch.prep"]
    trace.reset()
    launched = _lib.launches["phase_a_cuda"] - before["phase_a_cuda"]
    if launched != len(calls):
        raise AssertionError(f"{name}: {len(calls)} phase A calls, "
                             f"{launched} phase_a_cuda launches")
    if kernel != [1] * len(calls):
        raise AssertionError(f"{name}: phase_a spans read phase_a_kernel "
                             f"{kernel}")
    prepped = _lib.launches["prep_cuda"] - before["prep_cuda"]
    if not prep or prep != [1] * len(prep) \
            or prepped != PREP_LAUNCHES * len(prep):
        raise AssertionError(f"{name}: prep spans read prep_kernel {prep}, "
                             f"{prepped} prep_cuda launches")
    log(f"{name}: {cull.num_chunks} chunks of "
        f"{cull.num_groups // cull.num_chunks} groups, {len(calls)} phase A "
        f"calls a frame, each one phase_a_cuda launch and a phase_a span "
        f"reading phase_a_kernel 1; {len(prep)} preps, each "
        f"{PREP_LAUNCHES} prep_cuda launches and a prep span reading "
        f"prep_kernel 1")
    bounces = []
    for i, (feats, _, mg, mc) in enumerate(calls):
        if (mg, mc) == tuple(calls[0][2:4]):
            bounces.append(feats)
        phase_a_check(f"{name}, call {i} (bounce {len(bounces) - 1}, MG "
                      f"{mg} / MC {mc})",
                      torch.cat(bounds_from_feats(feats), dim=1), tables,
                      feats.shape[1], cone_budgets(cull, mg, mc),
                      timed=False)
    return bounces, tuple(calls[0][2:4])


def render_phase_a(dev):
    """Phase 7a: ``phase_a_cuda`` at several chunks. On the ``path_100k``
    cell's deployment (``benchmark/``: ``render_100k``, 100k spheres
    uniform in the 1000-unit cube, leaf 16: three chunks of 185 groups)
    one frame of its
    traffic with every phase A call checked (:func:`phase_a_calls`), then
    the camera rays and the rays leaving the first hit points at every
    rung of ``leafcull._escalate``'s ladder from the render's budgets to
    (G, lpc), each checked and timed beside the torch operations and its
    bound; then one path/auto frame of the CLI's benchmark scene (three
    chunks too), every call checked. Returns the camera rays' first-rung
    results row."""
    import torch
    from pathlib import Path
    from benchmark.harness import Bench
    from tracer_torch import cli
    from tracer_torch.bench import render as brender
    from tracer_torch.integrator.wavefront import bounce_noise
    from tracer_torch.kernels.conecull import bounds_from_feats, cone_budgets
    bench = Bench(Path("BENCHMARK.json"))
    cell = bench.cell("path_100k")
    drv = bench.driver("frame")
    st = drv.setup(bench.config(cell["config"]),
                   bench.traffic(cell["traffic"]), 2 ** 31 + 2121, dev)
    tables = st.tables["cone"]
    cull = tables.cull
    C, G, lpc = cull.num_chunks, cull.num_groups, cull.leaves_per_chunk
    if C < 2:
        raise AssertionError(f"the path_100k tables have {C} chunk")
    bounces, (mg, mc) = phase_a_calls(
        "path_100k frame", lambda: drv._frame(st, 0, drv._noise(st, 100)),
        tables)
    rungs = []
    while True:
        rungs.append((mg, mc))
        if mg >= G and mc >= lpc:
            break
        mg, mc = min(2 * mg, G), min(2 * mc, lpc)
    first = None
    for which, feats in (("camera rays", bounces[0]),
                         ("rays leaving hit points", bounces[1])):
        bounds = torch.cat(bounds_from_feats(feats), dim=1)
        for mg, mc in rungs:
            row = phase_a_check(
                f"phase A C = {C}, path_100k {which}, {bounds.shape[0]} "
                f"subpackets, MG {mg} / MC {mc}", bounds, tables,
                feats.shape[1], cone_budgets(cull, mg, mc))
            first = first or row
    del st, bounces, tables, cull
    torch.cuda.empty_cache()

    sess = cli.prepare(cli.build_parser().parse_args(
        brender.argv("path", "auto") + ["--frames", "1"]))
    cfg = sess.config
    noise = bounce_noise(torch.Generator(device=dev).manual_seed(3),
                         (cfg.height, cfg.width), cfg.max_depth, dev)
    phase_a_calls("CLI path/auto frame",
                  lambda: sess.frame(sess.camera, noise),
                  sess.tables["cone"])
    log(f"CLI path/auto frame escalations: {sess.counts}")
    return first


def synthetic_bounds(n, widths, gen, device):
    """(n, 12) f32 bounds [o_lo | o_hi | d_lo | d_hi] of skewed rows:
    origin boxes of side 0.02 at the world's centre, direction boxes of
    half width ``widths[i % len]`` round random unit directions (a width
    past a component's size straddles 0 on that axis)."""
    import torch
    d = torch.randn((n, 3), generator=gen)
    d = d / d.norm(dim=1, keepdim=True)
    w = torch.tensor(widths)[torch.arange(n) % len(widths)][:, None]
    o = (torch.rand((n, 3), generator=gen) - 0.5) * 0.02
    return torch.cat([o - 0.01, o + 0.01, d - w, d + w], dim=1).to(device)


def skewed_phase_a(tables, btables, dev):
    """Phase 3: ``phase_a_cuda`` on skewed rows, untimed: one-chunk rows
    on the 100k tables from hair-thin to every-group direction boxes
    (group mode from the leaf budget, from the group count and past the
    kept prefix), and routed rows on the 10M tables over random chunks,
    the last one included, with every fifth pair inactive."""
    import torch
    from tracer_torch.bench import headline
    from tracer_torch.kernels.conecull import cone_budgets
    from tracer_torch.kernels.tlas import pair_row_budgets
    gen = torch.Generator().manual_seed(21)
    S = headline.S
    widths = (0.0005, 0.005, 0.05, 0.5, 2.0)
    for mc in (headline.MC, 16):
        phase_a_check(f"phase A skewed one-chunk rows, MC {mc}",
                      synthetic_bounds(512 * S, widths, gen, dev), tables, S,
                      cone_budgets(tables.cull, headline.MG, mc),
                      timed=False)
    cull = btables.cull
    C, npairs, g = cull.num_chunks, 4096, 256
    pc = torch.randint(0, C, (npairs,), generator=gen, dtype=torch.int32)
    pc[-1] = C - 1
    pg = torch.randint(0, g, (npairs,), generator=gen, dtype=torch.int32)
    act = torch.arange(npairs) % 5 != 4
    pairs = tuple(x.to(dev) for x in (pc, pg, act))
    for mc in (119, 7):
        phase_a_check(f"phase A skewed routed rows, MC {mc}",
                      synthetic_bounds(g * S, widths, gen, dev), btables, S,
                      pair_row_budgets(cull, 32, mc), pairs, timed=False)


def compare_conecull(name, feats, rows, cones, cull):
    """conecull_cuda vs conecull_plain (t, slots, survivor counts) and vs
    leafcull_cuda (t, slots) on the same rows, all bit for bit. Returns
    (cone-test survivors, walked prims)."""
    import torch
    from tracer_torch.kernels.conecull import conecull_cuda, conecull_plain
    from tracer_torch.kernels.leafcull import leafcull_cuda
    args = walk_args(feats, rows, cull)[2:]
    tk, sk, kk = conecull_cuda(feats, rows, cones, *args)
    tp, sp, kp = conecull_plain(feats, rows, cones, *args,
                                pair_elems=PLAIN_ELEMS)
    tl, sl = leafcull_cuda(feats, rows, *args)
    torch.cuda.synchronize()
    if not (torch.equal(sk, sp) and torch.equal(tk, tp)
            and torch.equal(kk, kp)):
        raise AssertionError(f"{name}: conecull_cuda != plain on "
                             f"{int((sk != sp).sum())} slot(s), "
                             f"{int((tk != tp).sum())} t value(s), "
                             f"{int((kk != kp).sum())} survivor count(s)")
    if not (torch.equal(sk, sl) and torch.equal(tk, tl)):
        raise AssertionError(f"{name}: conecull_cuda != leafcull_cuda on "
                             f"{int((sk != sl).sum())} slot(s), "
                             f"{int((tk != tl).sum())} t value(s)")
    walked = int(walked_leaves(rows, cull.leaves_per_group).sum()) \
        * cull.leaf_size
    kept = int(kk.sum())
    log(f"{name}: {sk.numel()} ray results, {int((sk < 2 ** 30).sum())} "
        f"hits; {kept} of {walked} walked prims survive the cone test "
        f"({kept / max(walked, 1):.4f}); t, slots and survivor counts equal "
        f"conecull_plain, t and slots equal leafcull_cuda, bit for bit")
    return kept, walked


def conecull_bound(name, feats, rows, cones, cull, kept, walked):
    """Bound of the phase-B walk: a cone test per walked prim and a
    quadratic per (ray, survivor)."""
    quads = kept * feats.shape[2]
    n_bytes = nbytes(feats, rows, cones, cull.prims) \
        + rows.shape[0] * feats[..., 0].numel() * 8 + rows[..., 0].numel() * 4
    log(f"{name}: {walked} cone tests, {quads} (ray, survivor) tests, "
        f"{n_bytes} bytes")
    return bound(n_bytes, walked * OPS_PER_CONE + quads * OPS_PER_TEST)


def compare_cull(name, rays, tiles, cand, counts):
    """cull_cuda vs cull_plain: t and slots equal exactly. Returns the
    kernel's (t, slot)."""
    import torch
    from tracer_torch.kernels.cull import cull_cuda, cull_plain
    tk, sk = cull_cuda(rays, tiles, cand, counts)
    tp, sp = cull_plain(rays, tiles, cand, counts)
    torch.cuda.synchronize()
    if not (torch.equal(sk, sp) and torch.equal(tk, tp)):
        raise AssertionError(f"{name}: cull_cuda != plain on "
                             f"{int((sk != sp).sum())} slot(s), "
                             f"{int((tk != tp).sum())} t value(s)")
    K = cand.shape[1]
    walked = counts.reshape(-1).clamp(max=K)
    log(f"{name}: {rays.shape[0]} packets, {int(walked.sum())} listed tiles "
        f"walked (raw counts up to {int(counts.max())}, K = {K}), "
        f"{int((sk >= 0).sum())} hits; t and slots equal bit for bit")
    return tk, sk


def cull_bound(name, rays, tiles, cand, counts):
    """Bound of the packet cull: packets x 1024 x walked tiles x 128
    b-form tests."""
    from tracer_torch.kernels.traverse import PACKET
    tiles_walked = int(counts.reshape(-1).clamp(max=cand.shape[1]).sum())
    tests = tiles_walked * PACKET * 128
    n_bytes = nbytes(rays, tiles, cand, counts) + rays.shape[0] * PACKET * 8
    log(f"{name}: {tests} (ray, prim) tests, {n_bytes} bytes")
    return bound(n_bytes, tests * OPS_PER_BFORM)


def cull_rows(o, d, table, k):
    """Packed rays and tile candidates of rays in order: (rays, cand,
    counts, overflow)."""
    from tracer_torch.intersect.cull import tile_candidates
    from tracer_torch.kernels.leafcull import _pad_edge
    from tracer_torch.kernels.traverse import pack_rays
    rays, _, pad = pack_rays(o, d)
    cand, counts, ovf = tile_candidates(_pad_edge(o, pad), _pad_edge(d, pad),
                                        table, k)
    return rays, cand, counts, bool(ovf)


def packet_cull_walks(dev):
    """Phase 3d: cull_cuda vs its plain version at 20k spheres, 16-prim
    leaves, 64k + 37 direction-sorted origin rays: the full budget, an
    overflowing budget (the walk stops at K), and the sentinel tile listed
    after every packet's own tiles (which must change nothing)."""
    import torch
    from tracer_torch.bench import headline
    from tracer_torch.bvh.builder import build_bvh
    from tracer_torch.core.sort import sort_rays_by_direction
    from tracer_torch.core.types import Ray
    from tracer_torch.intersect.cull import build_leaf_table
    from tracer_torch.kernels.cull import cull_tiles
    from tracer_torch.kernels.traverse import pack_bvh
    scene, _, o, d, _ = headline.benchmark_inputs(
        dev, n_spheres=WALK_SPHERES, n_rays=WALK_RAYS + 37, world=500.0)
    rs, _ = sort_rays_by_direction(Ray(o, d))
    bvh = build_bvh(scene.centers, scene.radii, leaf_size=16,
                    backend="native", device=dev)
    table = build_leaf_table(bvh)
    T = table.num_tiles
    tiles = cull_tiles(pack_bvh(scene, bvh), T)
    n = rs.origin.shape[0]
    rays, cand, counts, ovf = cull_rows(rs.origin, rs.direction, table, T)
    if ovf:
        raise AssertionError("the packet cull overflowed at the full budget")
    t0, s0 = compare_cull(f"packet cull {WALK_SPHERES} x {n}, full budget",
                          rays, tiles, cand, counts)
    _, cand_k, counts_k, ovf_k = cull_rows(rs.origin, rs.direction, table,
                                           SMALL_CULL_K)
    if not ovf_k:
        raise AssertionError(f"a budget of {SMALL_CULL_K} tiles did not "
                             f"overflow")
    _, sk = compare_cull(f"packet cull {WALK_SPHERES} x {n}, budget "
                         f"{SMALL_CULL_K} (overflowing)", rays, tiles, cand_k,
                         counts_k)
    tile = torch.where(sk >= 0, sk // 128, cand_k[:, :1])
    if not (tile[:, :, None] == cand_k[:, None, :]).any(dim=2).all():
        raise AssertionError("the packet cull walked past its K candidates")
    lists, skew_counts = skewed_lists(rays.shape[0], T,
                                      torch.Generator().manual_seed(12))
    compare_cull(f"packet cull {WALK_SPHERES} x {n}, skewed rows (one lists "
                 f"all {T} tiles)", rays, tiles, lists.to(dev),
                 skew_counts.reshape(-1, 1).to(dev))
    listed = torch.cat([cand, torch.full_like(cand[:, :1], T)], dim=1)
    t1, s1 = compare_cull(f"packet cull {WALK_SPHERES} x {n}, sentinel tile "
                          f"listed", rays, tiles, listed, counts + 1)
    if not (torch.equal(s0, s1) and torch.equal(t0, t1)):
        raise AssertionError("the sentinel tile changed a result")


def cull_slice(dev, scene, o, d, results, comp):
    """Phase 5b: the packet cull at full size, 100k spheres in 16-prim
    leaves and the 512k origin rays sorted by direction, through
    ``nearest_hit_cull_checked`` from K = 128; counters reset just before
    and read just after, the compactor's planes recorded and checked
    (``comp``, a Compactions). Returns the 16-prim-leaf BVH."""
    import torch
    from tracer_torch.bench.timing import time_cuda
    from tracer_torch.bvh.builder import build_bvh
    from tracer_torch.core.sort import sort_rays_by_direction
    from tracer_torch.core.types import Ray
    from tracer_torch.intersect.brute import nearest_hit_brute_fast
    from tracer_torch.intersect.cull import build_leaf_table
    from tracer_torch.kernels import _lib
    from tracer_torch.kernels.cull import (cull_cuda, cull_plain,
                                           cull_tiles,
                                           nearest_hit_cull_checked)
    from tracer_torch.kernels.traverse import pack_bvh
    bvh = build_bvh(scene.centers, scene.radii, leaf_size=16,
                    backend="native", device=dev)
    packed = pack_bvh(scene, bvh)
    table = build_leaf_table(bvh)
    T = table.num_tiles
    rs, _ = sort_rays_by_direction(Ray(o, d))
    so, sd = rs.origin, rs.direction
    before = _lib.launches.copy()
    with comp.record():
        rec, esc = nearest_hit_cull_checked(rs, scene, packed, table,
                                            CULL_K)
    torch.cuda.synchronize()
    launches = launches_since(before, "cull_cuda", "compact_cuda")
    comp.check("packet cull", timed=1)
    k = min(CULL_K, T)
    for _ in range(esc):
        k = min(2 * k, T)
    log(f"packet cull slice launches: {launches}; {esc} escalation(s), "
        f"settled on K = {k} of {T} tiles")
    if min(launches.values()) < 1:
        raise AssertionError("the packet cull slice did not run through "
                             "every kernel")
    rays, cand, counts, ovf = cull_rows(so, sd, table, k)
    if ovf:
        raise AssertionError("the packet cull overflowed at the end of "
                             "escalation")
    n = BRUTE_RAYS
    on, dn = so[:n].contiguous(), sd[:n].contiguous()
    ids = rec.index.reshape(-1)[:n]
    sphere_of, t_of = sphere_of_in(scene), ref_t_of(on, dn, scene)
    ib_b = bform_brute_ids(on, dn, scene)
    check_choices(f"packet cull vs b-form brute (first {n} sorted rays)",
                  on, dn, sphere_of, rec.t.reshape(-1)[:n], ids, t_of(ib_b),
                  ib_b, -1)
    ib = nearest_hit_brute_fast(Ray(on, dn), scene, block=1024).index
    check_choices(f"packet cull vs nearest_hit_brute_fast (first {n} "
                  f"sorted rays)", on, dn, sphere_of, rec.t.reshape(-1)[:n],
                  ids, t_of(ib), ib, -1, MIN_AGREE_OTHER_ROUNDING)
    tiles = cull_tiles(packed, T)
    compare_cull(f"packet cull 100k x {o.shape[0]}, K = {k}", rays, tiles,
                 cand, counts)
    row_lengths("packet cull rows", counts.clamp(0, k))
    ladder = [min(CULL_K, T)]
    while ladder[-1] < k:
        ladder.append(min(2 * ladder[-1], T))
    log("packet cull escalation: listed tiles walked at K = " + ", ".join(
        f"{kk}: {int(counts.clamp(0, kk).sum())}" for kk in ladder))
    ms = time_cuda(cull_cuda, rays, tiles, cand, counts)
    pms = time_cuda(cull_plain, rays, tiles, cand, counts, warmup=0, iters=1)
    bms, bby = cull_bound("packet cull 100k x 512k", rays, tiles, cand,
                          counts)
    log(f"packet cull 100k x 512k: cuda {ms:.4f} ms, plain {pms:.4f} ms, "
        f"bound {bms:.4f} ms ({bby})")
    results["cull_cuda"] = dict(
        ms=ms, plain_ms=pms, library_ms=None, bound_ms=bms, bound_by=bby,
        max_abs_err=0, launches=launches["cull_cuda"])
    return bvh


def phase_b_slice(dev, scene, tables, bvh16, o, d, t_ref, sid_ref, results):
    """Phase 5c: the phase-B query at full size, 100k x 512k, on the
    headline tables (leaf 32) and on 16-prim leaves: prep_rays_bucketed,
    phase A with cones and the cone-cull walk through
    ``nearest_hit_conecull_t`` with the checked queries' budget doubling;
    launches counted from just before to just after; phase A is
    ``phase_a_cuda`` at both sizes (one chunk at leaf 32, three at leaf
    16), and the compactor must not run. At leaf 32 the slots
    and t must equal the headline leaf-walk query's (``t_ref``,
    ``sid_ref``, ray order) exactly; at both sizes the walk must equal
    conecull_plain and leafcull_cuda on its rows, and the ids brute
    force. The walk's rows are logged."""
    import torch
    from tracer_torch.bench import headline
    from tracer_torch.bench.timing import time_cuda, time_graph
    from tracer_torch.core.sort import prep_rays_bucketed
    from tracer_torch.core.types import Ray
    from tracer_torch.intersect.brute import brute_t_fast
    from tracer_torch.kernels import _lib
    from tracer_torch.kernels.conecull import (build_cone_tables,
                                               conecull_cuda, conecull_plain,
                                               nearest_hit_conecull_t)
    from tracer_torch.kernels.leafcull import (leafcull_cuda,
                                               pack_ray_features,
                                               _doubled_budgets, _escalate)
    S, SP = headline.S, headline.SP
    for leaf, tb in ((32, tables), (16, build_cone_tables(scene, bvh16))):
        # Phase A is phase_a_cuda at one chunk (leaf 32) and at three
        # (leaf 16); the compactor is not called.
        before = _lib.launches.copy()
        padded, pdest = prep_rays_bucketed(Ray(o, d), SP,
                                           cell_bits=headline.CELL_BITS)
        (t, sid, ovf), esc = _escalate(
            lambda k0, k: (lambda r: (r, r[2]))(nearest_hit_conecull_t(
                padded, tb, k0, k, S, SP)), padded.origin.shape[0],
            (headline.MG, headline.MC), _doubled_budgets(tb))
        torch.cuda.synchronize()
        launches = launches_since(before, "conecull_cuda", "phase_a_cuda")
        compacted = _lib.launches["compact_cuda"] - before["compact_cuda"]
        if compacted:
            raise AssertionError(f"phase B leaf {leaf}: the compactor ran "
                                 f"{compacted} time(s)")
        mg = min(headline.MG << esc, tb.cull.num_groups)
        mc = min(headline.MC << esc, tb.cull.leaves_per_chunk)
        log(f"phase B slice, leaf {leaf}: launches {launches}; {esc} "
            f"escalation(s), budgets MG {mg} / MC {mc}")
        if min(launches.values()) < 1:
            raise AssertionError("the phase-B slice did not run through "
                                 "every kernel")
        if bool(ovf):
            raise AssertionError("phase B overflowed at the end of "
                                 "escalation")
        t, sid = t[pdest], sid[pdest]
        if leaf == 32:
            if not (torch.equal(sid, sid_ref) and torch.equal(t, t_ref)):
                raise AssertionError(
                    f"phase B and the headline leaf walk differ on "
                    f"{int((sid != sid_ref).sum())} id(s), "
                    f"{int((t != t_ref).sum())} t value(s)")
            log(f"phase B leaf 32: ids and t equal the headline leaf-walk "
                f"query's on {sid.numel()} rays")
        n = BRUTE_RAYS
        tb_, ib = brute_t_fast(o[:n], d[:n], scene.centers, scene.radii,
                               block=1024)
        check_choices(f"phase B leaf {leaf} vs brute_t_fast (first {n} "
                      f"rays)", o[:n], d[:n], sphere_of_in(scene), t[:n],
                      sid[:n], tb_, ib, -1)
        feats, _, _ = pack_ray_features(padded.origin, padded.direction, S,
                                        SP)
        rows, cones = phase_a(feats, tb, mg, mc)
        cull = tb.cull
        kept, walked = compare_conecull(
            f"phase B walk 100k x {o.shape[0]}, leaf {leaf}", feats, rows,
            cones, cull)
        args = walk_args(feats, rows, cull)[2:]
        name = f"phase B walk, leaf {leaf}"
        leaf_rows(f"{name} rows", rows, cull.leaves_per_group)
        ms = time_cuda(conecull_cuda, feats, rows, cones, *args)
        gms = time_graph(conecull_cuda, feats, rows, cones, *args)
        lms = time_cuda(leafcull_cuda, feats, rows, *args)
        dms = kernel_ms(conecull_cuda, (feats, rows, cones, *args),
                        "cone_items")
        dlms = kernel_ms(leafcull_cuda, (feats, rows, *args), "ClosestWalk")
        pms = time_cuda(conecull_plain, feats, rows, cones, *args,
                        warmup=0, iters=1)
        bms, bby = conecull_bound(name, feats, rows, cones, cull, kept,
                                  walked)
        log(f"{name}: cuda {ms:.4f} ms (device time {gms:.4f} ms, the walk "
            f"kernel {fmt_ms(dms)} of it; leafcull_cuda on the same rows "
            f"{lms:.4f} ms, its walk kernel {fmt_ms(dlms)}), plain "
            f"{pms:.4f} ms, bound {bms:.4f} ms ({bby}); survivor share "
            f"{kept / walked:.4f}")
        if leaf == 32:
            results["conecull_cuda"] = dict(
                ms=ms, plain_ms=pms, library_ms=None, bound_ms=bms,
                bound_by=bby, max_abs_err=0,
                launches=launches["conecull_cuda"])


DIFF_CHECK_RAYS = 1024  # rays of the sparse-vs-dense checks (bench.py's)
DIFF_CHECK_LEAVES = 64  # and their leaves a subpacket (test_sparse_diff.py)
DENSE_BLOCK = 128       # rays a dense soft render takes at a time
FIT_STEPS = 20          # cli fit at 800x600: straight steps, and the
FIT_SPLIT = 10          # step its checkpoint is taken at before the resume
# The dense soft image in f32 against float64 on the check rays: the port's
# perp2 is the perpendicular vector's length, an ulp of |oc| off at most,
# which the edge sharpness (50 / r) turns into ~1e-3 of sigma for spheres
# ~900 units out; the cancelling |oc|^2 - t_ca^2 |d|^2 is off by ~1 there.
F64_IMAGE_ATOL = 2e-3
CAM_YAW_OFF = 0.02      # the camera fit's start: the cli fit's pose off by
CAM_POS_OFF = (0.1, 0.0, 0.0)   # 0.02 rad in yaw and 0.1 in x,
CAM_STEPS = 20          # fitted back in 20 steps at lr 3e-3 (the fit's
CAM_LR = 3e-3           # default 3e-2 overshoots the pose)


@contextlib.contextmanager
def plain_compactor():
    """Within the block, phase A's compactions run the plain version on
    the card's tensors, not compact_cuda."""
    from tracer_torch.kernels import conecull
    real = conecull.compact_ascending_rows
    conecull.compact_ascending_rows = conecull.compact_ascending_rows_plain
    try:
        yield
    finally:
        conecull.compact_ascending_rows = real


def diff_slice(dev, scene, tables, o, d, comp):
    """Phase 7c: the differentiable path on the headline's 100k scene.

    The bench extra's fwd+bwd once (the checked soft evaluation of
    131,072 rays at subpacket 64, escalated from 16 leaves a subpacket,
    over single-chunk tables from radii inflated to the logit clip, the
    gradient of its mean image with respect to the centres) with its
    launches counted, and its compactions checked
    (``comp``); leaf_candidates at that shape equal with compact_cuda and
    with the plain compactor, and timed; on tables from radii inflated by
    soft_radius_scale, 1,024 of the sorted rays at 64 leaves a subpacket:
    the sparse image against the dense one (atol 5e-3); the leaf-order
    image and gradient against the exact packets path's, logged; the
    leaf-order image and gradient on the card against the same function
    on the CPU (atol 1e-5; 1e-4 max |g| + 1e-7, the port-vs-JAX bounds of
    tests/test_torch_sparse_diff.py); the dense image and sigma against
    the same functions in float64 on the card; the bench extra's
    measurement; ``cli fit``
    at 800x600 and 20 spheres in a temporary directory, 20 steps with the
    loss falling, then 10 steps, a checkpoint and a resume to 20 whose
    losses and state equal the straight run's bit for bit; the camera fit
    from a perturbed pose; the identity
    refit of the 100k tree equal to its build, and timed. The bench
    extra's fwd+bwd and one fit step are profiled (device
    time, idle share, launches, top kernels). Returns the compactor's
    launches on the path."""
    import tempfile
    from dataclasses import replace

    import numpy as np
    import torch
    from tracer_torch import cli
    from tracer_torch.bench import headline
    from tracer_torch.bench.profile import (describe, diff_stages, fit_stage,
                                            profile_calls)
    from tracer_torch.bench.timing import time_cuda
    from tracer_torch.bvh.builder import build_bvh
    from tracer_torch.bvh.refit import build_refit_plan, refit_bvh
    from tracer_torch.core.types import Ray
    from tracer_torch.diff.soft import SoftParams, soft_render
    from tracer_torch.diff.sparse import (soft_radius_scale,
                                          soft_render_sparse,
                                          soft_render_sparse_leaforder,
                                          soft_render_sparse_packets)
    from tracer_torch.kernels import _lib
    from tracer_torch.kernels.leafcull import (build_cull_tables,
                                               leaf_candidates)
    cull = tables.cull
    if cull.num_chunks != 1:
        raise AssertionError("the headline tables are not single-chunk")
    po, pd = headline.diff_rays(o, d)
    sp, ml = headline.DIFF_SP, headline.DIFF_LEAVES

    # The main path, once, with its launches counted.
    dtables = headline.diff_tables(scene)
    before = _lib.launches.copy()
    with comp.record():
        grad, escalations = headline.diff_fwd_bwd(scene, dtables, o, d)
    torch.cuda.synchronize()
    del dtables
    launches = _lib.launches["compact_cuda"] - before["compact_cuda"]
    log(f"diff path launches: {{'compact_cuda': {launches}}}; "
        f"{po.shape[0] // sp} subpackets, {escalations} escalations")
    comp.check("diff", timed=2)
    if launches < 1:
        raise AssertionError("the diff path did not run compact_cuda")
    if not bool(torch.isfinite(grad).all()) or not bool((grad != 0).any()):
        raise AssertionError("the diff path's gradient is not finite or is "
                             "all zero")

    # leaf_candidates with compact_cuda and with the plain compactor.
    mg = 48
    rows, ovf = leaf_candidates(po, pd, cull, mg, ml, sp)
    with plain_compactor():
        prow, povf = leaf_candidates(po, pd, cull, mg, ml, sp)
        plain_ms = time_cuda(leaf_candidates, po, pd, cull, mg, ml, sp)
    if not torch.equal(rows, prow) or bool(ovf) != bool(povf):
        raise AssertionError("leaf_candidates differs between compact_cuda "
                             "and the plain compactor")
    lc_ms = time_cuda(leaf_candidates, po, pd, cull, mg, ml, sp)
    cnt = rows[0, :, 0]
    log(f"leaf_candidates {tuple(rows.shape)}: equal with compact_cuda and "
        f"the plain compactor; overflow {bool(ovf)}; group-mode rows "
        f"{int((cnt < 0).sum())}, mean leaves of leaf-mode rows "
        f"{cnt[cnt >= 0].float().mean().item():.2f}; {lc_ms:.4f} ms "
        f"(plain compactor {plain_ms:.4f} ms)")

    # Sparse against dense, leaf order against packets, on tables from
    # inflated radii.
    params = SoftParams()
    scale = soft_radius_scale(params)
    itables = build_cull_tables(scene, build_bvh(
        scene.centers, scene.radii * scale, leaf_size=cull.leaf_size,
        backend="native", device=dev))
    n, k = DIFF_CHECK_RAYS, DIFF_CHECK_LEAVES
    o1, d1 = po[:n].contiguous(), pd[:n].contiguous()
    with torch.no_grad():
        sparse, s_ovf = soft_render_sparse(scene, Ray(origin=o1,
                                                      direction=d1),
                                           itables, params, max_leaves=k)
        dense = torch.cat([soft_render(scene, None, params, rays=Ray(
            origin=o1[i:i + DENSE_BLOCK], direction=d1[i:i + DENSE_BLOCK]))
            for i in range(0, n, DENSE_BLOCK)])
    err = (sparse - dense).abs().max().item()
    log(f"sparse vs dense soft image, {n} rays x 100k spheres, {k} leaves: "
        f"overflow {bool(s_ovf)}, max |diff| {err:.3g} (bound 5e-3)")
    if bool(s_ovf) or not err <= 5e-3:
        raise AssertionError("sparse and dense soft images disagree")

    def loss_grad(fn, o, d, device):
        """(image, d mean(img^2) / d centres, overflow) of ``fn`` at the
        check's setting, computed on ``device``."""
        s = scene if device == dev else replace(
            scene, centers=scene.centers.to(device),
            radii=scene.radii.to(device), albedo=scene.albedo.to(device))
        t = itables if device == dev else replace(itables, **{
            f: getattr(itables, f).to(device) for f in (
                "prims", "leaf_min", "leaf_max", "group_boxes", "group_min",
                "group_max", "slot_to_sphere")})
        centers = s.centers.detach().requires_grad_(True)
        img, ovf = fn(replace(s, centers=centers), o.to(device),
                      d.to(device), t, params, max_leaves=k, subpacket=sp)
        (g,) = torch.autograd.grad(torch.mean(img ** 2), centers)
        return img.detach().to(dev), g.to(dev), bool(ovf)

    # The leaf-order composite shares one order per subpacket (leaf by
    # leaf, slot order inside a leaf), so where soft silhouettes overlap a
    # ray it misorders them. That is the model's deviation, the JAX
    # function's too: the 4e-3 of tests/test_sparse_diff.py holds on that
    # test's seed, not on a dense scene, where
    # tests/test_torch_sparse_diff.py holds the two packages equal while
    # both deviate. Logged here; the card is held to the CPU. (At this
    # setting, on an NVIDIA H100 80GB HBM3 at 700 W, the deviation was
    # 0.156 while perp2 cancelled and 3.4e-5 with perp2 taken from the
    # perpendicular vector.)
    pimg, pg, p_ovf = loss_grad(soft_render_sparse_packets, o1, d1, dev)
    limg, lg, l_ovf = loss_grad(soft_render_sparse_leaforder, o1, d1, dev)
    cimg, cg, _ = loss_grad(soft_render_sparse_leaforder, o1, d1,
                            torch.device("cpu"))
    dev_px = (limg - pimg).abs().amax(1)
    log(f"leaf-order vs packets, {n} rays x 100k spheres: image max |diff| "
        f"{dev_px.max().item():.3g} ({int((dev_px > 4e-3).sum())} of {n} "
        f"rays over 4e-3), gradient max |diff| "
        f"{(lg - pg).abs().max().item():.3g} (0.02 max |g| + 1e-7 = "
        f"{0.02 * pg.abs().max().item() + 1e-7:.3g}); overflow {p_ovf}, "
        f"{l_ovf}")
    ierr = (limg - cimg).abs().max().item()
    gerr = (lg - cg).abs().max().item()
    gtol = 1e-4 * cg.abs().max().item() + 1e-7
    log(f"leaf-order on the card vs on the CPU: image max |diff| "
        f"{ierr:.3g} (bound 1e-5), gradient max |diff| {gerr:.3g} (bound "
        f"{gtol:.3g})")
    if p_ovf or l_ovf or not bool(torch.isfinite(lg).all()) \
            or not ierr <= 1e-5 or not gerr <= gtol:
        raise AssertionError("the leaf-order path on the card disagrees "
                             "with the CPU, overflows or is not finite")

    soft_f64_check(dev, scene, o1, d1, params, dense, limg)
    del itables, sparse, dense, pimg, pg, limg, lg, cimg, cg

    # The bench extra's measurement, and where its time and a fit step's
    # go.
    rec = headline.measure_diff(scene, o, d)
    log(json.dumps(rec))
    if not (rec["diff_grad_finite"] and rec["diff_grad_nonzero"]):
        raise AssertionError("the bench extra's gradient is not finite or "
                             "is all zero")
    stages = {**diff_stages(scene, o, d), "fit_step": fit_stage(dev)}
    for name, (fn, *args) in stages.items():
        log(describe(name, profile_calls(fn, *args, iters=3)))

    # cli fit at 800x600, 20 spheres: straight, then split and resumed.
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        def fit(*extra):
            if cli.main(["fit", *extra]) != 0:
                raise AssertionError("cli fit failed")
            return np.loadtxt("fit_losses.txt")

        straight = fit("--steps", str(FIT_STEPS), "--checkpoint", "a.npz")
        if not straight[-1] < straight[0]:
            raise AssertionError(f"fit loss did not fall: {straight}")
        fit("--steps", str(FIT_SPLIT), "--checkpoint", "b.npz")
        resumed = fit("--steps", str(FIT_STEPS), "--checkpoint", "b.npz",
                      "--resume")
        with np.load("a.npz") as a, np.load("b.npz") as b:
            same = a.files == b.files and all(
                np.array_equal(a[f], b[f]) for f in a.files)
        if not (np.array_equal(straight, resumed) and same):
            raise AssertionError("the resumed fit is not bitwise the "
                                 "straight one")
        log(f"cli fit 800x600: loss {straight[0]:.6f} -> {straight[-1]:.6f} "
            f"in {FIT_STEPS} steps; resumed at step {FIT_SPLIT}: losses and "
            f"every state leaf bitwise equal")

    camera_fit_check(dev)

    # Refit at 100k spheres.
    bvh = build_bvh(scene.centers, scene.radii, leaf_size=cull.leaf_size,
                    backend="native", device=dev)
    plan = build_refit_plan(bvh)
    new = refit_bvh(bvh, plan, scene.centers, scene.radii)
    if not (torch.equal(new.node_min, bvh.node_min)
            and torch.equal(new.node_max, bvh.node_max)):
        raise AssertionError("the identity refit differs from the build")
    refit_ms = time_cuda(refit_bvh, bvh, plan, scene.centers, scene.radii)
    log(f"refit 100k ({bvh.num_nodes} nodes, {len(plan.level_nodes)} "
        f"levels): identity equal to the build; {refit_ms:.4f} ms")
    return launches


def soft_f64_check(dev, scene, o1, d1, params, dense, limg):
    """The dense soft image and sigma of the check rays in f32 against the
    same port functions in float64 on the card (the perp2 repair: within
    F64_IMAGE_ATOL), and the leaf-order f32 image against the float64 one,
    logged."""
    from dataclasses import replace

    import torch
    from tracer_torch.core.types import Ray
    from tracer_torch.diff.soft import _shade_sigma_t, soft_render
    n = o1.shape[0]
    s64 = replace(scene, centers=scene.centers.double(),
                  radii=scene.radii.double(), albedo=scene.albedo.double())
    o64, d64 = o1.double(), d1.double()
    sig_err, blocks = 0.0, []
    with torch.no_grad():
        for i in range(0, n, DENSE_BLOCK):
            b = slice(i, i + DENSE_BLOCK)
            blocks.append(soft_render(s64, None, params, rays=Ray(
                origin=o64[b], direction=d64[b])))
            sig32 = _shade_sigma_t(scene, o1[b], d1[b], params)[0]
            sig64 = _shade_sigma_t(s64, o64[b], d64[b], params)[0]
            if sig64.dtype != torch.float64:
                raise AssertionError("sigma did not run in float64")
            sig_err = max(sig_err,
                          (sig32.double() - sig64).abs().max().item())
    dense64 = torch.cat(blocks)
    if dense64.dtype != torch.float64 or dense64.device != dense.device \
            or dense.device.type != dev.type:
        raise AssertionError("the float64 image did not run on the card in "
                             "float64")
    e64 = (dense.double() - dense64).abs()
    lo64 = (limg.double() - dense64).abs().max().item()
    log(f"dense soft image f32 vs float64 on the card, {n} rays x "
        f"{scene.num_spheres} spheres: max |diff| {e64.max().item():.3g} "
        f"(bound {F64_IMAGE_ATOL:g}), mean {e64.mean().item():.3g}, "
        f"{int((e64.amax(1) > 1e-4).sum())} of {n} rays over 1e-4; sigma "
        f"max |diff| {sig_err:.3g}; the leaf-order f32 image vs the dense "
        f"float64 one {lo64:.3g} (the leaf order's own deviation included)")
    if not e64.max().item() <= F64_IMAGE_ATOL:
        raise AssertionError("the f32 soft image is off the float64 one")


def camera_fit_check(dev):
    """``fit_scene(optimize_camera=True)`` at the cli fit's setting (800x600,
    20 spheres) from the true scene and a perturbed pose: the view error at
    least halved; without optimize_camera the camera returned as passed."""
    import numpy as np
    import torch
    from tracer_torch import cli
    from tracer_torch.diff.fit import fit_scene, view_error
    args = cli.build_parser().parse_args(["fit"])
    cfg, cam, fsoft, target, _ = cli.fit_problem(args, dev)
    true_scene, _ = cli.make_scene_camera(args, dev)
    off = cam.replace(yaw=cam.yaw + CAM_YAW_OFF, position=cam.position
                      + torch.tensor(CAM_POS_OFF, device=dev))
    depth = torch.linalg.vector_norm(true_scene.centers - cam.position,
                                     dim=1).mean().item()
    res = fit_scene(target, true_scene, off, steps=CAM_STEPS, lr=CAM_LR,
                    soft=fsoft, config=cfg, optimize_camera=True)
    before, after = (view_error(c, cam, depth) for c in (off, res.camera))
    pose = {k: (getattr(res.camera, k) - getattr(cam, k)).tolist()
            for k in ("yaw", "pitch", "position")}
    log(f"camera fit {cfg.width}x{cfg.height} ({CAM_STEPS} steps, lr "
        f"{CAM_LR:g}) from yaw {CAM_YAW_OFF:+g}, position {CAM_POS_OFF}: "
        f"view error "
        f"{before:.5g} -> {after:.5g} rad (depth {depth:.2f}); pose error "
        f"after: {pose}; loss {res.losses[0]:.6g} -> {res.losses[-1]:.6g} "
        f"(least {res.losses.min():.6g}); {np.mean(res.step_ms[1:]):.3f} "
        f"ms/step")
    if not after < before / 2:
        raise AssertionError("the camera fit did not bring the pose back")
    still = fit_scene(target, true_scene, off, steps=2, soft=fsoft,
                      config=cfg)
    if not all(getattr(still.camera, k) is getattr(off, k)
               for k in ("position", "yaw", "pitch", "fov")):
        raise AssertionError("without optimize_camera the camera changed")
    log("fit without optimize_camera: the camera returned as passed")


# The soft evaluation's kernel against its plain version and autograd on
# the card (phase 7d), at grad_131k's shapes: image absolute, loss
# relative, gradients relative L2. The three sum in other orders, and the
# kernel adds its gradients with atomics (measured 6e-8, 1e-7 and 1.5e-7
# kernel vs plain, measured on one H100).
SOFT_IMG_ATOL, SOFT_LOSS_RTOL, SOFT_GRAD_RTOL = 1e-5, 1e-5, 1e-4
SOFT_RAYS = 131_072
# Work of a real (ray, candidate) pair in one forward and one backward:
# float32 operations and special-function ones (exp, log1p, sqrt, the
# divisions' reciprocals), and the special-function units' rate on one
# H100 SXM (16 a clock on each of 132 SMs at 1.98 GHz).
SOFT_OPS_PER_PAIR, SOFT_SFU_PER_PAIR = 200, 16
SFU_OPS_PER_S = 132 * 16 * 1.98e9


def soft_slice(dev, scene, results):
    """Phase 7d: the checked soft evaluation (``soft_loss_grad_sparse``)
    at grad_131k's shapes: ``scene``'s spheres moved as ``cli fit`` moves
    them, tables from radii inflated at widths 30, 131,072 origin rays, a
    target, subpacket 64, cell bits 8, from (48, 16), blocks of 4 GiB.
    The kernel path, its plain version on the card and autograd over
    ``_soft_block`` (both through ``sparse.soft_paths``): image, loss and
    gradients held to each other; every ``composite`` span reads
    ``soft_kernel`` 1; the kernel's launches an evaluation; the composite
    and backward of each timed on CUDA events, the kernels by name on the
    profiler's device time, and the bound (operations of the real pairs
    and the candidate rows' bytes)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from tracer_torch import trace
    from tracer_torch.bench import headline
    from tracer_torch.core.types import Ray
    from tracer_torch.diff import sparse
    from tracer_torch.diff.soft import SoftParams
    from tracer_torch.kernels import _lib
    from tracer_torch.scene.scene import Scene
    params = SoftParams()
    g = torch.Generator(device=dev).manual_seed(27)
    moved = Scene(
        centers=scene.centers + 0.1 * torch.mean(scene.radii) * torch.randn(
            scene.centers.shape, generator=g, device=dev),
        radii=scene.radii,
        albedo=torch.clamp(scene.albedo + 0.2, 0.05, 0.95))
    tables = headline.diff_tables(moved)
    d = torch.rand((SOFT_RAYS, 3), generator=g, device=dev) * 2.0 - 1.0
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    rays = Ray(origin=torch.zeros_like(d), direction=d)
    target = torch.rand((SOFT_RAYS, 3), generator=g, device=dev)
    paths = sparse.soft_paths

    def autograd_composite(sc, o, dd, ids, valid, widths, own, tgt, n, tb,
                           prm, sp):
        leaves = [x.detach().requires_grad_(True)
                  for x in (sc.centers, sc.radii, sc.albedo)]
        with torch.enable_grad():
            img, real = sparse._soft_block(*leaves, o, dd, ids, valid, tb,
                                           prm, sp)
            keep = (own < n)[:, None]
            diff = img - tgt[torch.clamp(own, max=n - 1)]
            term = torch.sum(torch.where(keep, diff * diff,
                                         torch.zeros_like(diff)))
        return img.detach(), term.detach(), real.sum(1), (term, leaves, n)

    def autograd_backward(state, grads, prm):
        term, leaves, n = state
        with torch.enable_grad():     # the evaluation's blocks run no_grad
            (term / (3 * n)).backward()
        for gr, x in zip(grads, leaves):
            gr += x.grad

    def run(kind):
        """One evaluation by ``kind``, its composite and backward between
        CUDA events: (loss, image, grads, ms)."""
        comp, back, lane = {
            "kernel": paths(True), "plain": paths(False),
            "autograd": (autograd_composite, autograd_backward,
                         sparse.LANE_BYTES)}[kind]
        marks = []

        def timed_comp(*a):
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
            return comp(*a)

        def timed_back(*a):
            back(*a)
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        sparse.soft_paths = lambda kernel: (timed_comp, timed_back, lane)
        try:
            loss, img, grads, _ = sparse.soft_loss_grad_sparse(
                moved, rays, target, tables, params, 48, 16, 64, 8, 4 << 30)
        finally:
            sparse.soft_paths = paths
        torch.cuda.synchronize()
        ms = sum(a.elapsed_time(b) for a, b in zip(marks[::2], marks[1::2]))
        return loss, img, grads, ms

    run("kernel")
    before = _lib.launches.copy()
    k_loss, k_img, k_grads, _ = run("kernel")
    launched = launches_since(before, "soft_cuda")["soft_cuda"]
    k_ms = sorted(run("kernel")[3] for _ in range(5))[2]
    t0 = time.perf_counter()
    for _ in range(3):
        sparse.soft_loss_grad_sparse(moved, rays, target, tables, params,
                                     48, 16, 64, 8, 4 << 30)
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) / 3 * 1e3
    trace.reset()
    with trace.enabled():
        sparse.soft_loss_grad_sparse(moved, rays, target, tables, params,
                                     48, 16, 64, 8, 4 << 30)
    torch.cuda.synchronize()
    comps = [s for root in trace.records() for s in root["spans"]
             if s["name"] == "tracer_torch.composite"]
    if not comps or any(s["counters"]["soft_kernel"] != 1 for s in comps):
        raise AssertionError("a composite span of the soft evaluation did "
                             "not run the kernel")
    pairs = sum(int(s["counters"]["candidates"]) for s in comps)
    lanes = sum(int(s["counters"]["lanes"]) for s in comps)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sparse.soft_loss_grad_sparse(moved, rays, target, tables, params,
                                     48, 16, 64, 8, 4 << 30)
        torch.cuda.synchronize()
    by_kernel = {}
    for e in prof.key_averages():
        if "soft_" in e.key:
            name = e.key.split("::")[-1].split("(")[0]
            by_kernel[name] = by_kernel.get(name, 0.0) \
                + e.device_time_total / 1e3
    p_loss, p_img, p_grads, p_ms = run("plain")
    a_loss, a_img, a_grads, a_ms = run("autograd")

    def rel(a, b):
        return float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b))
    errs = {}
    for name, (loss, img, grads) in (("plain", (p_loss, p_img, p_grads)),
                                     ("autograd", (a_loss, a_img, a_grads))):
        errs[name] = (float((k_img - img).abs().max()),
                      abs(float(k_loss) - float(loss)) / float(loss),
                      max(rel(x, y) for x, y in zip(k_grads, grads)))
    ops_s = pairs * (SOFT_OPS_PER_PAIR / FP32_OPS_PER_S
                     + SOFT_SFU_PER_PAIR / SFU_OPS_PER_S)
    # The candidate rows written and read, the rays read, the image and
    # the gradients' atomics once.
    n_bytes = pairs // 64 * 32 * 2 + SOFT_RAYS * (24 + 12) \
        + pairs // 64 * 28
    bms, bby = (ops_s * 1e3, "operations") \
        if ops_s >= n_bytes / HBM_BYTES_PER_S \
        else (n_bytes / HBM_BYTES_PER_S * 1e3, "bytes")
    log(f"soft {SOFT_RAYS} rays x {scene.centers.shape[0]} spheres: "
        f"{pairs} real pairs of {lanes} lanes (fill {pairs / lanes:.4f}); "
        f"{launched} soft_cuda launches an evaluation, every composite "
        f"span soft_kernel 1; composite + backward on events: kernel "
        f"{k_ms:.4f} ms (median of 5), plain {p_ms:.4f} ms, autograd "
        f"{a_ms:.4f} ms; the kernels' device time "
        f"{json.dumps({k: round(v, 4) for k, v in by_kernel.items()})}; "
        f"evaluation {eval_ms:.2f} ms; bound {bms:.4f} ms ({bby}); kernel "
        f"vs plain image {errs['plain'][0]:.3g}, loss {errs['plain'][1]:.3g}"
        f", grads {errs['plain'][2]:.3g}; vs autograd image "
        f"{errs['autograd'][0]:.3g}, loss {errs['autograd'][1]:.3g}, grads "
        f"{errs['autograd'][2]:.3g}")
    for name, (img_err, loss_err, grad_err) in errs.items():
        if img_err > SOFT_IMG_ATOL or loss_err > SOFT_LOSS_RTOL \
                or grad_err > SOFT_GRAD_RTOL:
            raise AssertionError(f"the soft kernel is off its {name} "
                                 f"version: {img_err}, {loss_err}, "
                                 f"{grad_err}")
    results["soft_cuda"] = dict(
        ms=k_ms, plain_ms=p_ms, library_ms=None, bound_ms=bms, bound_by=bby,
        max_abs_err=errs["plain"][0], launches=launched,
        autograd_ms=a_ms, device_ms=sum(by_kernel.values()))
    del moved, tables, rays, target
    torch.cuda.empty_cache()


def time_compactor(name, ids, sentinel, keep):
    """compact_cuda vs its plain version on one plane, exactly, and the
    plane timed on CUDA events over back-to-back calls: (ms, plain_ms,
    library_ms, bound_ms), the library call torch.sort, the yardstick,
    which puts the survivors first (the sentinel exceeds every id). The
    kernel's device time (timing.time_graph: a call is shorter than the
    host's time to issue it) is logged beside."""
    import torch
    from tracer_torch.bench.timing import time_cuda, time_graph
    from tracer_torch.kernels.conecull import (compact_ascending_rows_plain,
                                               compact_cuda)
    P, M = ids.shape
    keep = min(keep, M)
    ok, ck = compact_cuda(ids, sentinel, keep)
    op, cp = compact_ascending_rows_plain(ids, sentinel, keep)
    torch.cuda.synchronize()
    if not (torch.equal(ok, op) and torch.equal(ck, cp)):
        raise AssertionError(f"{name}: compact_cuda != plain")
    if not torch.equal(torch.sort(ids, dim=1).values[:, :keep], op):
        raise AssertionError(f"{name}: torch.sort is not the compactor's "
                             f"yardstick")
    ms = time_cuda(compact_cuda, ids, sentinel, keep)
    gms = time_graph(compact_cuda, ids, sentinel, keep)
    pms = time_cuda(compact_ascending_rows_plain, ids, sentinel, keep)
    lms = time_cuda(torch.sort, ids, 1)
    bms, _ = bound(nbytes(ids, ok, ck), P * M * OPS_PER_ID)
    log(f"{name}: equal; cuda {ms:.4f} ms (device time {gms:.4f} ms), plain "
        f"{pms:.4f} ms, torch.sort {lms:.4f} ms, bound {bms:.4f} ms")
    return ms, pms, lms, bms


# The kernels each row path of the sweep launches per query.
SWEEP_KERNELS = {"dense_brute_fast": set(),
                 "hybrid_feats": {"prep_cuda", "leafcull_cuda",
                                  "phase_a_cuda"},
                 "tlas_routed": {"prep_cuda", "routed_cuda", "compact_cuda",
                                 "phase_a_cuda"}}
TOOLS_RENDER = ["render", "--scene", "benchmark", "--spheres", "100000",
                "--compact"]   # path/auto, 800x600, depth 5
DEBUG_RAYS = 4096       # rays of the checked per-ray walk at 100k spheres


def check_sweep_row(name, o, d, scene, ta, ia, tb, ib):
    """A sweep row's (t, sphere id) against brute force's on the same
    rays: ids equal on >= MIN_AGREE of rays, every other ray a tie or a
    graze; where both chose one sphere, t within T_RTOL unless the ray
    grazes it (brute force's reference quadratic rounds the discriminant
    another way than the walks' u-form)."""
    ia, ib = ia.long(), ib.long()
    sphere_of = sphere_of_in(scene)
    same = ia == ib
    hit = same & (ia >= 0)
    rel = (ta - tb).abs() / tb.abs()
    loose = hit & (rel > T_RTOL)
    if loose.any():
        c, q = sphere_of(ia[loose])
        loose_grazes = int(grazing(o[loose], d[loose], c, q).sum())
    else:
        loose_grazes = 0
    n_loose = int(loose.sum())
    bad = ~same
    ca, qa = sphere_of(ia[bad])
    cb, qb = sphere_of(ib[bad])
    ties, grazes, other = classify(
        o[bad], d[bad], {"a": ca, "b": cb}, {"a": qa, "b": qb}, ta[bad],
        tb[bad], ia[bad] >= 0, ib[bad] >= 0)
    agree = same.float().mean().item()
    inside = rel[hit & ~loose]
    log(f"{name}: {ia.numel()} rays, {int(hit.sum())} same hits (max t rel "
        f"err {inside.max().item() if inside.numel() else 0.0:.3g}, "
        f"{n_loose} beyond {T_RTOL:g}, {loose_grazes} of them grazes), "
        f"ids agree on {agree:.6f}; mismatches: {ties} tie(s), {grazes} "
        f"graze(s), {other} other")
    if agree < MIN_AGREE or other or loose_grazes < n_loose:
        raise AssertionError(f"{name}: the row and brute force disagree")


def routed_row(n, tables, o, d, budgets, comp):
    """A 100M sweep row's routed query on its own arguments at its settled
    ``budgets``: stage times (prep, routing + phase A, walk, merge), the
    kernels' launches in one query, the compactor's planes (held to its
    plain version, timed), ``routed_cuda`` against ``routed_plain`` bit for
    bit on the first ``PAIR_SLICE`` pairs, its time on every pair and its
    bound. Returns the walk's numbers for the log."""
    import torch
    from tracer_torch.bench import harness, large
    from tracer_torch.bench.timing import time_cuda
    from tracer_torch.kernels import _lib
    from tracer_torch.kernels.conecull import bounds_from_feats, phase_a_cuda
    from tracer_torch.kernels.tlas import (pair_row_budgets, route_pairs,
                                           routed_call, routed_plain,
                                           tlas_candidates, tlas_merge)
    cull = tables.cull
    mg, mc, npairs, kc = budgets
    name = f"routed n={n} x {o.shape[0]} rays"
    pblk = large.budgets(n, cull.num_chunks, o.shape[0])[3]
    feats, _ = large.prep(o, d)
    ph = (feats, tables, mg, mc, npairs, kc, pblk)
    prep_ms = time_cuda(large.prep, o, d)
    phase_a_ms = time_cuda(tlas_candidates, *ph, warmup=1, iters=3)
    rows, pc, pg, merge_pos, ovf = tlas_candidates(*ph)
    if bool(ovf):
        raise AssertionError(f"n={n}: routed phase A overflowed at its "
                             f"settled budgets")
    # The first block of pairs the torch operations took at a time, and
    # the same rows of the kernel's one launch over every pair.
    S = feats.shape[1]
    bounds = bounds_from_feats(feats)
    act = route_pairs(*bounds, tables, S, npairs, kc)[2]
    bounds = torch.cat(bounds, dim=1)
    blk = (pc[:pblk], pg[:pblk], act[:pblk])
    pa_budgets = pair_row_budgets(cull, mg, mc)
    pa = phase_a_check(f"{name}, phase A, first {blk[0].shape[0]} pairs",
                       bounds, tables, S, pa_budgets, blk)
    first, _ = phase_a_cuda(bounds, tables, S, *pa_budgets, *blk)
    if not torch.equal(first, rows[:pblk].reshape(first.shape)):
        raise AssertionError(f"{name}: phase_a_cuda's rows of the first "
                             f"block differ from its launch over every pair")
    args = (pc, pg, rows, feats, cull.prims, cull.leaf_size,
            cull.leaves_per_chunk, cull.leaves_per_group)
    walk_ms = time_cuda(routed_call, *args, warmup=1, iters=3)
    t_p, s_p = routed_call(*args)
    merge_ms = time_cuda(tlas_merge, t_p, s_p, merge_pos)
    before = _lib.launches.copy()
    with comp.record():
        harness._prep_query(harness.nearest_hit_tlas_feats, o, d, tables,
                            mg, mc, npairs, kc, pblk)
    torch.cuda.synchronize()
    launches = launches_since(before, "routed_cuda", "compact_cuda",
                              "phase_a_cuda")
    comp.check(name, timed=3)
    k = min(PAIR_SLICE, pc.shape[0])
    sl = (pc[:k], pg[:k], rows[:k], *args[3:])
    compare_routed(f"{name}, first {k} pairs", sl)
    plain_ms = time_cuda(lambda *a: routed_plain(*a, pair_elems=PLAIN_ELEMS),
                         *sl, warmup=1, iters=1)
    leaf_rows(f"{name}, rows", rows, cull.leaves_per_group)
    bms, bby = walk_bound(name, feats, rows, cull,
                          walked_leaves(rows, cull.leaves_per_group),
                          rows.shape[0] * feats.shape[2] * feats.shape[1]
                          * 8, extra=(pc, pg))
    del rows, t_p, s_p
    log(f"{name}: {pc.shape[0]} pairs, budgets {budgets}, launches "
        f"{launches}; prep {prep_ms:.3f} ms, routing + phase A "
        f"{phase_a_ms:.3f} ms, walk {walk_ms:.3f} ms (routed_cuda; plain "
        f"{plain_ms:.3f} ms on the first {k} pairs), merge {merge_ms:.3f} "
        f"ms; walk bound {bms:.4f} ms ({bby})")
    return {"ms": walk_ms, "plain_ms_slice": plain_ms, "slice": k,
            "bound_ms": bms, "bound_by": bby, "launches": launches,
            "phase_a": pa}


def sweep_slice(comp):
    """Phase 8b: ``cli bench`` over the published decades in a temporary
    directory, every kernel's launches counted from just before to just
    after. Each row's query calls are counted on their own (the kernels
    they launch, per call) and their last result held against the last
    brute-force result of the row on the rays brute force timed, or, where
    the sweep skipped brute force, against ``harness.brute_t`` on the
    first ``BRUTE_RAYS_100M`` rays over the row's scene drawn again from
    its seed (``routed_row`` then checks the row's routed query)."""
    import collections
    import tempfile
    import torch
    from tracer_torch import cli
    from tracer_torch.bench import harness
    from tracer_torch.bench.timing import time_cuda
    from tracer_torch.kernels import _lib
    rows, brutes, starts = {}, {}, {}
    real_row_query, real_brute_t = harness.row_query, harness.brute_t
    real_scene = harness.sweep_scene

    def sweep_scene(n, *a):
        starts[n] = time.perf_counter()
        return real_scene(n, *a)

    def row_query(n, scene, tables, o, d, dense_limit, log):
        query, path, esc, budgets = real_row_query(n, scene, tables, o, d,
                                                   dense_limit, log)
        rec = rows[n] = {"path": path, "esc": esc, "budgets": budgets,
                         "calls": 0, "launches": collections.Counter(),
                         "scene": scene, "tables": tables, "o": o, "d": d}

        def counted():
            before = _lib.launches.copy()
            out = query()
            rec["calls"] += 1
            rec["launches"].update(_lib.launches - before)
            rec["out"] = out
            return out
        return counted, path, esc, budgets

    def brute_t(o, d, centers, radii):
        brutes[centers.shape[0]] = out = real_brute_t(o, d, centers, radii)
        return out

    t0 = time.perf_counter()
    start = _lib.launches.copy()
    harness.row_query, harness.brute_t = row_query, brute_t
    harness.sweep_scene = sweep_scene
    try:
        with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
            if cli.main(["bench", "--sizes",
                         ",".join(map(str, harness.PUBLISHED_SIZES))]) != 0:
                raise AssertionError("cli bench failed")
            with open("benchmark_results.json") as f:
                rec = json.load(f)
            with open("benchmark_data.txt") as f:
                data_rows = f.read().splitlines()
            with open("benchmark_results.png", "rb") as f:
                png = f.read()
    finally:
        harness.row_query, harness.brute_t = real_row_query, real_brute_t
        harness.sweep_scene = real_scene
    launches = dict(_lib.launches - start)
    t_end = time.perf_counter()
    sweep_s = t_end - t0
    log(f"sweep ({len(rec['sizes'])} sizes x {rec['num_rays']} rays, "
        f"{sweep_s:.1f} s): launches {launches}; {len(data_rows)} data rows, "
        f"{len(png)} bytes of PNG; device {rec['device']}")
    if len(data_rows) != len(harness.PUBLISHED_SIZES) or \
            not png.startswith(b"\x89PNG"):
        raise AssertionError("cli bench did not write its files")
    ends = [starts[n] for n in rec["sizes"][1:]] + [t_end]
    for i, n in enumerate(rec["sizes"]):
        r, stats = rows[n], rec["row_stats"][i]
        base = r["path"].split("_escalated")[0]
        per_call = {k: v / r["calls"] for k, v in r["launches"].items() if v}
        if set(per_call) != SWEEP_KERNELS[base]:
            raise AssertionError(f"n={n}: the {r['path']} row launched "
                                 f"{per_call}")
        if base == "tlas_routed" and r["esc"] and stats["chunks"] <= 256:
            raise AssertionError(f"n={n}: the routed row overflowed at the "
                                 f"JAX harness's budgets")
        nb = rec["brute_nb_timed"][i]
        log(f"sweep n={n}: {rec['row_paths'][i]}, {stats['chunks']} "
            f"chunk(s), budgets {stats['budgets']}, {r['esc']} "
            f"escalation(s); scene {stats['scene_ms']:.1f} ms, build "
            f"{rec['build_ms'][i]:.1f} ms, tables {stats['tables_ms']:.1f} "
            f"ms; brute {rec['brute_s'][i]:.6f} s ({nb} rays timed), bvh "
            f"{rec['bvh_s'][i]:.6f} s ({rec['mrays_bvh'][i]:.3f} Mrays/s, "
            f"speedup {rec['speedup'][i]:.1f}); peak "
            f"{stats['peak_mib']:.1f} MiB; {ends[i] - starts[n]:.1f} s of "
            f"sweep; launches per query {per_call}")
        ta, ia = r["out"]
        if nb:
            tb, ib = brutes[n]
            check_sweep_row(f"sweep n={n} vs brute force (first {nb} rays)",
                            r["o"][:nb], r["d"][:nb], r["scene"], ta[:nb],
                            ia[:nb], tb, ib)
            continue
        t1 = time.perf_counter()
        m = BRUTE_RAYS_100M
        scene = harness.sweep_scene(n, 0, 1000.0, r["o"].device)
        tb, ib = harness.brute_t(r["o"][:m], r["d"][:m], scene.centers,
                                 scene.radii)
        check_sweep_row(f"sweep n={n} vs brute force (first {m} rays, the "
                        f"scene drawn again)", r["o"][:m], r["d"][:m], scene,
                        ta[:m], ia[:m], tb, ib)
        del scene, tb, ib
        walk = routed_row(n, r["tables"], r["o"], r["d"], r["budgets"], comp)
        # The same tables at the published sweep's rays.
        o5, d5 = harness.origin_rays(PUBLISHED_RAYS, 0, r["o"].device)
        query, path, esc, b5 = harness.row_query(n, None, r["tables"], o5,
                                                 d5, 0, log)
        q_ms = time_cuda(query)
        walk5 = routed_row(n, r["tables"], o5, d5, b5, comp)
        log(f"sweep n={n} at {PUBLISHED_RAYS} rays: {path}, query "
            f"{q_ms:.3f} ms ({PUBLISHED_RAYS / q_ms / 1e3:.3f} Mrays/s); "
            f"routed_cuda {walk5}")
        del query, o5, d5
        log(f"sweep n={n}: the smoke's checks {time.perf_counter() - t1:.1f} "
            f"s; the row adds "
            f"{ends[i] - starts[n] + time.perf_counter() - t1:.1f} s in all; "
            f"routed_cuda {walk}")
    rows.clear()
    torch.cuda.empty_cache()
    log(f"sweep complexity: {json.dumps(rec['complexity'])}")
    missing = {"prep_cuda", "leafcull_cuda", "compact_cuda", "routed_cuda",
               "phase_a_cuda"} - set(launches)
    if missing:
        raise AssertionError(f"the sweep launched no {sorted(missing)}")
    return rec, launches


def tools_slice(scene, bvh16, o, d):
    """Phase 8c: ``cli render`` path/auto at 800x600 and 100k spheres with
    compaction: 4 frames straight with a checkpoint, 2 frames and a resume
    to 4 bitwise equal to them, still and flying; ``--profile`` over two
    frames, its trace naming a kernel of the port; two frames under
    ``TRACER_DEBUG=1``, equal to two unchecked ones, and their cost; the
    checked per-ray walk on the headline scene's 16-prim tree, clean and
    with a NaN ray direction; ``cli viz`` at 800x600."""
    import io
    import os
    import tempfile
    import numpy as np
    import torch
    from tracer_torch import cli
    from tracer_torch.core.types import Ray
    from tracer_torch.debug import DebugError, checked_nearest_hit
    from tracer_torch.intersect.traverse import nearest_hit_bvh
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        def render(*extra):
            if cli.main([*TOOLS_RENDER, *extra]) != 0:
                raise AssertionError(f"cli render {extra} failed")

        for fly in ("0", "1"):
            render("--fly-speed", fly, "--frames", "4", "--checkpoint",
                   "s.npz", "--out", "s.png")
            render("--fly-speed", fly, "--frames", "2", "--checkpoint",
                   "c.npz", "--out", "c.png")
            render("--fly-speed", fly, "--frames", "4", "--checkpoint",
                   "c.npz", "--resume", "--out", "c.png")
            a, b = np.load("s.npy"), np.load("c.npy")
            if not np.array_equal(a, b):
                raise AssertionError(
                    f"render resumed at frame 2 (fly speed {fly}) differs "
                    f"from the straight run on {int((a != b).sum())} values")
            log(f"render resume, fly speed {fly}: 4 frames straight and 2 + "
                f"a resume to 4 bitwise equal (image mean {a.mean():.6f})")
            os.remove("s.npz")
            os.remove("c.npz")

        render("--frames", "2", "--profile", "prof", "--out", "p.png")
        with open(os.path.join("prof", "trace.json")) as f:
            trace = json.load(f)
        kernels = {e["name"] for e in trace["traceEvents"]
                   if e.get("cat") == "kernel"}
        ours = sorted(k for k in kernels if "walk_items" in k
                      or "compact_rows" in k)
        log(f"render --profile: {len(trace['traceEvents'])} events, "
            f"{len(kernels)} kernel names, of the port's: {ours}")
        if not ours:
            raise AssertionError("the profile trace names no kernel of the "
                                 "port")

        os.environ["TRACER_DEBUG"] = "1"
        try:
            render("--frames", "2", "--metrics", "debug.json", "--out",
                   "debug.png")
        finally:
            del os.environ["TRACER_DEBUG"]
        render("--frames", "2", "--metrics", "plain.json", "--out",
               "plain.png")
        if not np.array_equal(np.load("debug.npy"), np.load("plain.npy")):
            raise AssertionError("the frames under TRACER_DEBUG=1 differ")
        with open("debug.json") as f:
            dbg = json.load(f)["mean_frame_s"]
        with open("plain.json") as f:
            plain = json.load(f)["mean_frame_s"]
        log(f"TRACER_DEBUG=1: a clean path/auto frame passes, equal to the "
            f"unchecked one; frame {dbg:.4f} s against {plain:.4f} s "
            f"unchecked")

        n = DEBUG_RAYS
        rays = Ray(origin=o[:n], direction=d[:n])
        t1 = time.perf_counter()
        err, rec = checked_nearest_hit(rays, scene, bvh16)
        err.throw()
        checked_s = time.perf_counter() - t1
        if not torch.equal(rec.t, nearest_hit_bvh(rays, scene, bvh16).t):
            raise AssertionError("the checked walk differs from the walk")
        bad = d[:n].clone()
        bad[5, 0] = float("nan")
        err, _ = checked_nearest_hit(Ray(origin=o[:n], direction=bad), scene,
                                     bvh16)
        try:
            err.throw()
        except DebugError as e:
            log(f"checked_nearest_hit, {n} rays x 100k spheres: clean passes "
                f"({checked_s:.2f} s); a NaN direction raises: {e}")
        else:
            raise AssertionError("a NaN ray direction passed the check")

        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            status = cli.main(["viz", "--out", "viz.png"])
        text = out.getvalue()
        stats = json.loads(text[:text.index("}") + 1])
        size = os.path.getsize("viz.png")
        log(f"cli viz 800x600: bvh_stats {json.dumps(stats)}; PNG {size} "
            f"bytes")
        if status != 0 or not stats["num_leaves"] or size < 1000:
            raise AssertionError("cli viz failed")
    log(f"render flags, debug and viz took {time.perf_counter() - t0:.1f} s")


RING_SPHERES = 100_352  # the ring check's scene (tests/test_dist.py's)
RING_RAYS = 1024
FIT_STEPS_DIST = 5      # sharded fit steps at 800x600
FIT_TILES = 4           # its gradient microbatches
FIT_LOSS_RTOL = 1e-5    # T = FIT_TILES against T = 1: losses, and centres
FIT_CENTRE_ATOL = 1e-3 * 3e-2   # (1e-3 of Adam's step at the fit's lr)
LITE_RTOL = 1e-4        # nearest_hit_leafcull_t's t against the epilogue's


def dist_slice(dev, scene, tables, o, d):
    """Phase 8d: the distribution at world size 1 over NCCL. The ray-sharded
    headline query, ``measure_scaling``, the sharded path frames (auto and
    pallas), the ring (brute and one-shard BVH), the sharded training step
    and the sharded fit (T = 1 and T = 4), each against its unsharded twin
    and timed beside it; then ``nearest_hit_leafcull_t`` on the headline.
    Launches are counted from just before each query to just after."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from tracer_torch import cli
    from tracer_torch.bench import headline
    from tracer_torch.bench import render as brender
    from tracer_torch.bench.scaling import measure_scaling
    from tracer_torch.bench.timing import time_cuda
    from tracer_torch.core.sort import sort_rays_octahedral
    from tracer_torch.core.types import Ray
    from tracer_torch.diff.fit import BETAS, EPS, fit_scene, params_to_scene
    from tracer_torch.diff.soft import soft_render
    from tracer_torch.dist import (RAY_AXIS, build_sharded_bvh,
                                   make_train_step, nearest_hit_ring,
                                   nearest_hit_sharded, ray_mesh,
                                   render_sharded, scene_mesh)
    from tracer_torch.integrator.wavefront import bounce_noise, render
    from tracer_torch.intersect.brute import nearest_hit_brute
    from tracer_torch.kernels import _lib
    from tracer_torch.kernels.leafcull import (nearest_hit_leafcull,
                                               nearest_hit_leafcull_t)
    from tracer_torch.scene.camera import camera_rays
    from tracer_torch.scene.scene import benchmark_scene
    t_phase = time.perf_counter()

    def run_counted(fn, *a):
        before = _lib.launches.copy()
        out = fn(*a)
        torch.cuda.synchronize()
        return out, dict(_lib.launches - before)

    def timed(name, sharded, twin, iters=5, labels=("sharded", "unsharded")):
        ms = time_cuda(sharded, warmup=1, iters=iters)
        ms_twin = time_cuda(twin, warmup=1, iters=iters)
        log(f"dist {name}: {labels[0]} {ms:.3f} ms, {labels[1]} "
            f"{ms_twin:.3f} ms")

    t0 = time.perf_counter()
    mesh = ray_mesh(device=dev)
    probe = torch.ones(1, device=dev)
    dist.all_reduce(probe, group=mesh.get_group(RAY_AXIS))
    torch.cuda.synchronize()
    log(f"dist: process group of world size {dist.get_world_size()} "
        f"(backend {dist.get_backend()}) and its first all-reduce in "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")

    # -- the ray-sharded headline query -------------------------------------
    cull = tables.cull

    def head(r, s):
        t, slot, dest, overflow = headline.query(r.origin, r.direction,
                                                 tables)
        t, slot = t[dest], slot[dest]
        sid = torch.where(slot >= 0, cull.slot_to_sphere[
            slot.clamp(min=0).long()], torch.full_like(slot, -1))
        return t, sid, overflow.expand(t.shape[0])

    rays = Ray(origin=o, direction=d)
    (ts, ids, ovf), n = run_counted(nearest_hit_sharded, rays, scene, mesh,
                                    head)
    log(f"dist sharded headline query launches: {n}")
    if n != {"prep_cuda": PREP_LAUNCHES, "leafcull_cuda": 1,
             "phase_a_cuda": 1}:
        raise AssertionError("the sharded query did not launch prep, phase "
                             "A and the leaf walk once each")
    tu, idu, ovu = head(rays, scene)
    if bool(ovf.any()) or bool(ovu.any()):
        raise AssertionError("the headline query overflowed")
    if not (torch.equal(ts, tu) and torch.equal(ids, idu)):
        raise AssertionError("the sharded headline query differs from the "
                             "unsharded one")
    log(f"dist sharded headline query: t and ids bitwise the unsharded "
        f"query's on {ts.numel()} rays")
    timed(f"headline query ({o.shape[0]} rays)",
          lambda: nearest_hit_sharded(rays, scene, mesh, head),
          lambda: head(rays, scene))
    rows = measure_scaling(scene, rays, head, device_counts=[1], reps=3)
    log(f"dist measure_scaling: {json.dumps(rows)}")

    # -- the sharded path frames ----------------------------------------------
    for impl, kernels in (("auto", ("prep_cuda", "leafcull_cuda",
                                    "phase_a_cuda")),
                          ("pallas", ("traverse_cuda",))):
        args = [a for a in brender.argv("path", impl) if a != "--compact"]
        sess = cli.prepare(cli.build_parser().parse_args(args))
        cfg = sess.config

        def nearest(r, s, sess=sess):
            return sess.nearest(s)(r)
        img, n = run_counted(render_sharded, sess.scene, sess.camera,
                             torch.Generator(device=dev).manual_seed(1),
                             mesh, nearest, cfg)
        log(f"dist sharded render path/{impl} launches: {n}")
        if min(n.get(k, 0) for k in kernels) < 1:
            raise AssertionError(f"the sharded path/{impl} frame did not "
                                 f"launch {kernels}")
        noise = bounce_noise(torch.Generator(device=dev).manual_seed(1),
                             (cfg.height, cfg.width), cfg.max_depth, dev)
        ref = render(sess.scene, sess.camera, None, sess.nearest, cfg,
                     noise=noise)
        if not (img.shape == (cfg.height, cfg.width, 3)
                and torch.equal(img, ref)):
            raise AssertionError(f"the sharded path/{impl} frame differs "
                                 "from the unsharded one")
        log(f"dist sharded render path/{impl}: bitwise the unsharded frame "
            f"({cfg.width}x{cfg.height}, depth {cfg.max_depth})")
        timed(f"path/{impl} frame",
              lambda: render_sharded(sess.scene, sess.camera,
                                     torch.Generator(device=dev)
                                     .manual_seed(1), mesh, nearest, cfg),
              lambda: render(sess.scene, sess.camera, None, sess.nearest,
                             cfg, noise=noise), iters=2)
        del sess, img, ref, noise

    # -- the ring ---------------------------------------------------------------
    ring_scene = benchmark_scene(torch.Generator().manual_seed(2),
                                 RING_SPHERES, world_size=1000.0, device=dev)
    rng = np.random.default_rng(0)
    rd = rng.uniform(-1, 1, (RING_RAYS, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    ro = rng.uniform(-200, 200, (RING_RAYS, 3)).astype(np.float32)
    ring_rays = Ray(origin=torch.as_tensor(ro, device=dev),
                    direction=torch.as_tensor(rd, device=dev))
    ref = nearest_hit_brute(ring_rays, ring_scene)
    t0 = time.perf_counter()
    sbvh = build_sharded_bvh(ring_scene.centers, ring_scene.radii,
                             num_shards=1, leaf_size=8, device=dev)
    log(f"dist build_sharded_bvh (1 shard, leaf 8): "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms, "
        f"{sbvh.node_min.shape[1]} nodes")
    for name, kw in (("brute", {}), ("one-shard BVH", {"sbvh": sbvh})):
        got = nearest_hit_ring(ring_rays, ring_scene, mesh, axis=RAY_AXIS,
                               **kw)
        check_choices(f"dist ring {name} vs nearest_hit_brute "
                      f"({RING_SPHERES} spheres x {RING_RAYS} rays)",
                      ring_rays.origin, ring_rays.direction,
                      sphere_of_in(ring_scene), got.t, got.index, ref.t,
                      ref.index, -1)
        timed(f"ring {name}",
              lambda kw=kw: nearest_hit_ring(ring_rays, ring_scene, mesh,
                                             axis=RAY_AXIS, **kw),
              lambda: nearest_hit_brute(ring_rays, ring_scene), iters=3)
    del ring_scene, ref, sbvh

    # -- the sharded training step and fit --------------------------------------
    cfg, cam, soft, target, init = cli.fit_problem(
        cli.build_parser().parse_args(["fit"]), dev)
    crays = camera_rays(cam, cfg)
    fo, fd = crays.origin.reshape(-1, 3), crays.direction.reshape(-1, 3)
    ftarget = target.reshape(-1, 3)
    k_top = init.num_spheres
    init_fn, factory = make_train_step(scene_mesh(1, 1, device=dev),
                                       soft=soft, k_top=k_top)
    params, state = init_fn(init)
    step = factory(state)
    with torch.no_grad():
        img = soft_render(params_to_scene(params), None, soft,
                          rays=Ray(origin=fo, direction=fd))
        ref_loss = float(torch.mean((img - ftarget) ** 2))
    p0 = params["centers"].clone()
    params1, state1, l1 = step(params, state, fo, fd, ftarget)
    params2, _, l2 = step(params1, state1, fo, fd, ftarget)
    log(f"dist train step ({cfg.width}x{cfg.height}, {k_top} spheres, "
        f"k_top {k_top}): loss {float(l1):.8g} (unsharded soft_render "
        f"{ref_loss:.8g}), then {float(l2):.8g}")
    if abs(float(l1) - ref_loss) > 1e-5 * abs(ref_loss):
        raise AssertionError("the sharded step's loss is not soft_render's")
    # One step's first moment is 0.1 g: g against the unsharded gradient.
    ref_p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    torch.mean((soft_render(params_to_scene(ref_p), None, soft, rays=Ray(
        origin=fo, direction=fd)) - ftarget) ** 2).backward()
    gerr = max(((state1.mu[k] / 0.1 - p.grad).abs().max()
                / p.grad.abs().max()).item() for k, p in ref_p.items())
    log(f"dist train step gradient (0.1 g from Adam's first moment) vs the "
        f"unsharded gradient: within {gerr:.3g} of the largest (bound 1e-5)."
        f" R = S = 1 on one card, so the division by R * S that makes the "
        f"sharded gradient the loss's is by 1 here and cannot show; the "
        f"gloo tests on 8 CPU ranks hold it on 4 meshes")
    if not gerr <= 1e-5:
        raise AssertionError("the sharded step's gradient is not the "
                             "unsharded one")
    del ref_p
    if not (torch.isfinite(l2) and float(l2) <= float(l1)
            and not torch.equal(params2["centers"], p0)):
        raise AssertionError("two sharded steps did not move the centres")

    def twin_step():
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        loss = torch.mean((soft_render(params_to_scene(p), None, soft,
                                       rays=Ray(origin=fo, direction=fd))
                           - ftarget) ** 2)
        loss.backward()
        torch.optim.Adam(list(p.values()), lr=1e-2, betas=BETAS,
                         eps=EPS).step()
    timed("train step", lambda: step(params, state, fo, fd, ftarget),
          twin_step, iters=3)

    def fit(**kw):
        return fit_scene(target, init, cam, steps=FIT_STEPS_DIST, soft=soft,
                         config=cfg, **kw)
    plain = fit()
    one = fit(mesh=ray_mesh(1, device=dev))
    tiles = fit(mesh=ray_mesh(1, device=dev), grad_microbatch=FIT_TILES)
    if not (np.array_equal(one.losses, plain.losses)
            and torch.equal(one.scene.centers, plain.scene.centers)):
        raise AssertionError("the sharded fit (T = 1) is not bitwise the "
                             "unsharded fit")
    dl = float(np.max(np.abs(tiles.losses - plain.losses)
                      / np.abs(plain.losses)))
    dc = (tiles.scene.centers - plain.scene.centers).abs()
    c = plain.scene.centers.abs()
    ulps = (dc / (torch.finfo(torch.float32).eps
                  * torch.exp2(torch.floor(torch.log2(c))))).max().item()
    log(f"dist fit ({FIT_STEPS_DIST} steps): T = 1 bitwise the unsharded "
        f"fit; T = {FIT_TILES}: losses within {dl:.3g} relative, centres "
        f"within {dc.max().item():.3g} ({ulps:.0f} ulps at most); ms per "
        f"step after the first: unsharded {np.mean(plain.step_ms[1:]):.3f}"
        f", T = 1 {np.mean(one.step_ms[1:]):.3f}, T = {FIT_TILES} "
        f"{np.mean(tiles.step_ms[1:]):.3f}")
    # Each tile's backward sums its rays in another order than the whole
    # batch's: a gradient that cancels over 480,000 rays keeps up to ~1e-3
    # of relative rounding, and Adam's normalised step (lr 3e-2) passes it
    # on as ~1e-3 of a step, whatever the coordinate's magnitude.
    if dl > FIT_LOSS_RTOL or dc.max().item() > FIT_CENTRE_ATOL:
        raise AssertionError(f"the microbatched fit (T = {FIT_TILES}) "
                             "drifted from the single all-reduce")
    dist.destroy_process_group()
    del params, state, params1, state1, params2, plain, one, tiles

    # -- nearest_hit_leafcull_t on the headline ---------------------------------
    srays, _ = sort_rays_octahedral(rays)
    mg, mc = headline.MG, headline.MC
    while True:
        (t_l, id_l, ovf), n = run_counted(
            nearest_hit_leafcull_t, srays, cull, mg, mc, headline.S,
            headline.SP)
        if not bool(ovf):
            break
        if mg >= cull.num_groups and mc >= cull.leaves_per_chunk:
            raise AssertionError("nearest_hit_leafcull_t overflows at every "
                                 "budget")
        mg, mc = 2 * mg, 2 * mc
    log(f"dist nearest_hit_leafcull_t (sorted headline rays, budgets {mg}, "
        f"{mc}) launches: {n}")
    if n != {"leafcull_cuda": 1, "compact_cuda": 2}:
        raise AssertionError("nearest_hit_leafcull_t did not launch the leaf "
                             "walk once and the compactor twice")
    rec, ovf = nearest_hit_leafcull(srays, scene, tables, headline.MG,
                                    headline.MC, headline.S, headline.SP,
                                    headline.CELL_BITS)
    if bool(ovf) or not torch.equal(id_l, rec.index):
        raise AssertionError("nearest_hit_leafcull_t's ids differ from "
                             "nearest_hit_leafcull's")
    hit = id_l >= 0
    rel = ((t_l[hit] - rec.t[hit]).abs() / rec.t[hit].abs()).max().item()
    log(f"dist nearest_hit_leafcull_t: ids equal nearest_hit_leafcull's on "
        f"{id_l.numel()} rays ({int(hit.sum())} hits), t within {rel:.3g} "
        f"relative")
    if rel > LITE_RTOL:
        raise AssertionError("nearest_hit_leafcull_t's t is off")
    timed("closest hit of the sorted headline rays",
          lambda: nearest_hit_leafcull_t(srays, cull, mg, mc, headline.S,
                                         headline.SP),
          lambda: nearest_hit_leafcull(srays, scene, tables, headline.MG,
                                       headline.MC, headline.S, headline.SP,
                                       headline.CELL_BITS),
          labels=("nearest_hit_leafcull_t", "nearest_hit_leafcull"))
    log(f"dist slice took {time.perf_counter() - t_phase:.1f} s")


def main(argv=None) -> int:
    import argparse
    import torch
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--compact-baseline", metavar="FILE.cu",
                    help="another compactor source exporting "
                    "tracer_compact_rows (an older checkout's "
                    "tracer_torch/csrc/compact.cu), held equal to "
                    "compact_cuda and timed beside it on every path's planes")
    args = ap.parse_args(argv)
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
    from tracer_torch.bench.compact import baseline
    comp = Compactions(baseline(args.compact_baseline)
                       if args.compact_baseline else None)

    from tracer_torch.bench import headline, large
    from tracer_torch.bench.timing import time_cuda
    from tracer_torch.intersect.brute import any_hit_brute, brute_t_fast
    from tracer_torch.core.types import Ray
    from tracer_torch.kernels.conecull import (bounds_from_feats,
                                               cone_budgets,
                                               nearest_hit_hybrid_feats)
    from tracer_torch.kernels.leafcull import (
        anyhit_cuda, anyhit_plain, leafcull_cuda, leafcull_plain,
        pack_ray_features, prep_feats_bucketed)
    from tracer_torch.kernels.tlas import (
        nearest_hit_tlas_feats, pair_row_budgets, route_pairs, routed_cuda,
        routed_plain, tlas_candidates)
    results = {}

    def shadow_prep(o, d, t_max):
        tm = torch.full((o.shape[0],), t_max, device=o.device)
        return prep_feats_bucketed(o, d, headline.S, headline.SP,
                                   cell_bits=headline.CELL_BITS, t_max=tm)[0]

    def phase_a_rows(feats, tables, mc=headline.MC):
        return phase_a(feats, tables, mc=mc)[0]

    # -- 3a. compact_cuda vs plain at the 100k query's phase-A shapes -----
    gen = torch.Generator().manual_seed(7)
    cres = [0.0] * 4
    for P, M, keep in ((4608, 384, 384), (4608, 1024, 512)):
        ids, sentinel = masked_rows(P, M, gen, dev)
        got = time_compactor(f"compact ({P}, {M}) keep {keep}", ids,
                             sentinel, keep)
        cres = [a + b for a, b in zip(cres, got)]
    results["compact_cuda"] = dict(
        zip(("ms", "plain_ms", "library_ms", "bound_ms"), cres),
        bound_by="bytes", max_abs_err=0)

    # -- 3b. the walks vs their plain versions at 20k spheres -------------
    for name, mc, world, table_args in (
            ("20k x 64k", headline.MC, 500.0, {}),
            ("20k x 64k, group mode", 7, 500.0, {}),
            ("20k x 64k, C > 1", headline.MC, 500.0,
             {"max_chunk_bytes": 256 << 10}),
            ("20k x 64k, dense", headline.MC, 40.0, {})):
        _, tables, o, d, _ = headline.benchmark_inputs(
            dev, n_spheres=20_000, n_rays=65_536, world=world, **table_args)
        C = tables.cull.num_chunks
        feats, _ = headline.prep(o, d)
        rows = phase_a_rows(feats, tables, mc)
        if mc == 7 and not (rows[..., 0] < 0).any():
            raise AssertionError("budget 7 made no group-mode row")
        if table_args and C < 2:
            raise AssertionError("small max_chunk_bytes kept one chunk")
        if world == 500.0:
            compare_walk(f"walk {name} ({C} chunk(s))", feats, rows,
                         tables.cull)
            compare_conecull(f"phase B {name} ({C} chunk(s))", feats, rows,
                             phase_a(feats, tables, mc=mc)[1], tables.cull)
            if not table_args and mc == headline.MC:
                base = (tables, o, d)
        sfeats = shadow_prep(o, d, SMALL_T_MAX if world == 500.0 else 500.0)
        full = compare_anyhit(f"any-hit {name} ({C} chunk(s))", sfeats,
                              phase_a_rows(sfeats, tables, mc), tables.cull)
        if world == 40.0 and not full:
            raise AssertionError("the dense scene left the early exit idle")
        if C > 1:
            # Budgets that hold every pair: this setting checks results.
            cull = tables.cull
            npairs = C * feats.shape[0]
            trows, pc, pg, _, _ = tlas_candidates(
                feats, tables, headline.MG, headline.MC, npairs, C)
            compare_routed(f"routed {name} ({C} chunks)",
                           (pc, pg, trows, feats, cull.prims, cull.leaf_size,
                            cull.leaves_per_chunk, cull.leaves_per_group))
            srows = skewed_routed_rows(
                pc, trows.shape[1], trows.shape[2], cull.leaves_per_chunk,
                cull.leaves_per_group, torch.Generator().manual_seed(15))
            gpc = cull.leaves_per_chunk // cull.leaves_per_group
            sname = (f"routed {name} ({C} chunks), skewed rows (one row a "
                     f"chunk walks all {gpc} groups)")
            leaf_rows(sname, srows, cull.leaves_per_group)
            compare_routed(sname, (pc, pg, srows, feats, cull.prims,
                                   cull.leaf_size, cull.leaves_per_chunk,
                                   cull.leaves_per_group))
            _, s_r, o_r = nearest_hit_tlas_feats(
                feats, tables, headline.MG, headline.MC, npairs, C)
            _, s_d, o_d = nearest_hit_hybrid_feats(feats, tables)
            if bool(o_r) or bool(o_d) or not torch.equal(s_r, s_d):
                raise AssertionError(
                    f"routed and dense queries disagree (overflow {bool(o_r)}"
                    f", {bool(o_d)}; {int((s_r != s_d).sum())} slot(s))")
            log(f"TLAS {name}: slots equal the dense query on "
                f"{s_r.numel()} rays")

    # Unsorted rays: subpackets whose directions straddle the origin get
    # degenerate cones, which accept every prim.
    tables, o, d = base
    ufeats, _, _ = pack_ray_features(o, d, headline.S, headline.SP)
    urows, ucones = phase_a(ufeats, tables)
    n_deg = int((ucones[..., 6] >= 1e17).sum())
    if not n_deg:
        raise AssertionError("unsorted rays made no degenerate cone")
    compare_conecull(f"phase B 20k x 64k, unsorted ({n_deg} of "
                     f"{ucones.shape[0] * ucones.shape[1]} cones degenerate)",
                     ufeats, urows, ucones, tables.cull)

    tie_breaks(dev)
    skewed_leaf_walks(dev)
    packet_and_tile_walks(dev)
    packet_cull_walks(dev)
    prep_slice(dev, results)

    # -- 4. the closest-hit slice at full size -----------------------------
    scene, tables, o, d, build_ms = headline.benchmark_inputs(dev)
    cull = tables.cull
    log(f"100k scene: bvh build {build_ms:.1f} ms, {cull.num_chunks} "
        f"chunk(s), {cull.num_real_leaves} leaves")
    before = _lib.launches.copy()
    with comp.record():
        t, slot, dest, overflow = headline.query(o, d, tables)
    torch.cuda.synchronize()
    launches = launches_since(before, "prep_cuda", "leafcull_cuda",
                              "phase_a_cuda")
    log(f"closest-hit slice launches: {launches}")
    comp.check("headline", timed=2)
    if launches != {"prep_cuda": PREP_LAUNCHES, "leafcull_cuda": 1,
                    "phase_a_cuda": 1}:
        raise AssertionError("the slice did not run prep, phase A and the "
                             "walk through their kernels")
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

    check_choices(f"slice vs brute_t_fast (first {n} rays)", o[:n], d[:n],
                  sphere_of_in(scene), tr[:n], sid[:n], tb, ib, -1)

    feats, _ = headline.prep(o, d)
    budgets = cone_budgets(cull, headline.MG, headline.MC)
    results["phase_a_cuda"] = phase_a_check(
        "phase A 100k x 512k", torch.cat(bounds_from_feats(feats), dim=1),
        tables, headline.S, budgets)
    results["phase_a_cuda"]["launches"] = launches["phase_a_cuda"]
    rows = phase_a_rows(feats, tables)
    compare_walk("walk 100k x 512k", feats, rows, cull)
    leaf_rows("walk 100k x 512k rows", rows, cull.leaves_per_group)
    args = walk_args(feats, rows, cull)
    walk_ms = time_cuda(leafcull_cuda, *args)
    walk_plain_ms = time_cuda(leafcull_plain, *args, warmup=1, iters=3)
    wb, wby = walk_bound("walk 100k x 512k", feats, rows, cull,
                         walked_leaves(rows, cull.leaves_per_group),
                         feats.shape[0] * feats.shape[1] * feats.shape[2]
                         * rows.shape[0] * 8)
    log(f"walk 100k x 512k: cuda {walk_ms:.4f} ms, plain "
        f"{walk_plain_ms:.4f} ms, bound {wb:.4f} ms ({wby})")
    results["leafcull_cuda"] = dict(
        ms=walk_ms, plain_ms=walk_plain_ms, library_ms=None, bound_ms=wb,
        bound_by=wby, max_abs_err=0,
        launches=launches["leafcull_cuda"])
    results["compact_cuda"]["launches"] = 0    # phase A is one kernel

    # -- 5. the shadow slice at full size ----------------------------------
    before = _lib.launches.copy()
    with comp.record():
        occ, sdest, s_overflow = headline.shadow_query(o, d, tables)
    torch.cuda.synchronize()
    s_launches = launches_since(before, "prep_cuda", "anyhit_cuda",
                                "phase_a_cuda")
    log(f"shadow slice launches: {s_launches}")
    comp.check("shadow")
    if min(s_launches.values()) < 1 \
            or s_launches["prep_cuda"] != PREP_LAUNCHES:
        raise AssertionError("the shadow slice did not run through every "
                             "kernel")
    if bool(s_overflow):
        raise AssertionError("phase A overflowed in the shadow slice")
    occ = occ[sdest].bool()
    t_max = headline.SHADOW_T_MAX
    check_occlusion("shadow vs closest-hit t < 500", o, d, occ,
                    tr < t_max, scene.centers, scene.radii, t_max)
    ref = any_hit_brute(Ray(origin=o[:n], direction=d[:n]), scene, t_max,
                        block=1024)
    check_occlusion(f"shadow vs any_hit_brute (first {n} rays)", o[:n],
                    d[:n], occ[:n], ref, scene.centers, scene.radii, t_max,
                    MIN_AGREE_REFERENCE)
    sfeats = shadow_prep(o, d, t_max)
    phase_a_check("phase A any-hit 100k x 512k",
                  torch.cat(bounds_from_feats(sfeats), dim=1), tables,
                  headline.S, budgets, timed=False)
    srows = phase_a_rows(sfeats, tables)
    compare_anyhit("any-hit 100k x 512k", sfeats, srows, cull)
    leaf_rows("any-hit 100k x 512k rows", srows, cull.leaves_per_group)
    sargs = walk_args(sfeats, srows, cull)
    any_ms = time_cuda(anyhit_cuda, *sargs)
    any_plain_ms = time_cuda(anyhit_plain, *sargs, warmup=1, iters=3)
    ab, aby = walk_bound("any-hit 100k x 512k", sfeats, srows, cull,
                         anyhit_leaves_needed(sfeats, srows, cull),
                         sfeats[..., 0].numel() * 4)
    log(f"any-hit 100k x 512k: cuda {any_ms:.4f} ms, plain "
        f"{any_plain_ms:.4f} ms, bound {ab:.4f} ms ({aby})")
    results["anyhit_cuda"] = dict(
        ms=any_ms, plain_ms=any_plain_ms, library_ms=None, bound_ms=ab,
        bound_by=aby, max_abs_err=0, launches=s_launches["anyhit_cuda"])
    log_beside_expanded("walk 100k x 512k", walk_ms)
    log_beside_expanded("any-hit 100k x 512k", any_ms)

    # -- 5a. the leaf walks on rays off the world's origin -------------------
    oo, od = off_origin_rays(scene, OFF_ORIGIN_RAYS, seed=31)
    ofeats, _ = headline.prep(oo, od)
    orows = phase_a_rows(ofeats, tables)
    compare_walk(f"walk 100k x {OFF_ORIGIN_RAYS} off the origin", ofeats,
                 orows, cull)
    osfeats = shadow_prep(oo, od, t_max)
    osrows = phase_a_rows(osfeats, tables)
    compare_anyhit(f"any-hit 100k x {OFF_ORIGIN_RAYS} off the origin",
                   osfeats, osrows, cull)
    log(f"walks 100k x {OFF_ORIGIN_RAYS} off the origin: closest hit "
        f"{time_cuda(leafcull_cuda, *walk_args(ofeats, orows, cull)):.4f} "
        f"ms, any hit "
        f"{time_cuda(anyhit_cuda, *walk_args(osfeats, osrows, cull)):.4f} "
        f"ms")
    del oo, od, ofeats, orows, osfeats, osrows

    # -- 5b, 5c. the packet cull and phase B at full size -------------------
    bvh16 = cull_slice(dev, scene, o, d, results, comp)
    phase_b_slice(dev, scene, tables, bvh16, o, d, tr, sid, results)

    # -- 6. the 10M TLAS slice at full size ---------------------------------
    big, btables, bo, bd, lbvh_ms, tables_ms = large.benchmark_inputs(dev)
    bcull = btables.cull
    budget = large.budgets(large.N_SPHERES, bcull.num_chunks)
    log(f"10M scene: device LBVH {lbvh_ms:.1f} ms, tables {tables_ms:.1f} "
        f"ms, {bcull.num_chunks} chunks; budgets (mg, npairs, kc, block) "
        f"{budget}")
    before = _lib.launches.copy()
    with comp.record():
        bt, bslot, bdest, b_overflow = large.query(bo, bd, btables, budget)
    torch.cuda.synchronize()
    b_launches = launches_since(before, "prep_cuda", "routed_cuda",
                                "compact_cuda", "phase_a_cuda")
    log(f"TLAS slice launches: {b_launches}")
    comp.check("10M TLAS", timed=3)
    if min(b_launches.values()) < 1 \
            or b_launches["prep_cuda"] != PREP_LAUNCHES:
        raise AssertionError("the TLAS slice did not run through every "
                             "kernel")
    if bool(b_overflow):
        raise AssertionError("the TLAS query overflowed at the harness "
                             "budgets")
    bfeats, _ = large.prep(bo, bd)
    dt, ds, d_overflow = nearest_hit_hybrid_feats(bfeats, btables,
                                                  DENSE_MG, large.MC)
    if bool(d_overflow):
        raise AssertionError("the dense 10M comparison overflowed")
    if not torch.equal(bslot, ds):
        raise AssertionError(f"TLAS and dense slots differ on "
                             f"{int((bslot != ds).sum())} rays")
    hit = ds >= 0
    log(f"TLAS vs dense multi-chunk: slots equal on {ds.numel()} rays, "
        f"max |t| difference {(bt[hit] - dt[hit]).abs().max().item():.3g}; "
        f"hit fraction {torch.isfinite(bt[bdest]).float().mean().item():.4f}")
    m = BRUTE_RAYS_10M
    btr, bsr = bt[bdest], bslot[bdest]
    bsid = torch.where(bsr >= 0,
                       bcull.slot_to_sphere[bsr.clamp(min=0).long()], -1)
    tb, ib = brute_t_fast(bo[:m], bd[:m], big.centers, big.radii, block=16)
    check_choices(f"10M TLAS vs brute_t_fast (first {m} rays)", bo[:m],
                  bd[:m], sphere_of_in(big), btr[:m], bsid[:m], tb, ib, -1)
    boo, bod = off_origin_rays(big, large.B, seed=37)
    del big, dt, ds, tb, ib

    mg, npairs, kc, pblk = budget
    npairs = min(npairs, bcull.num_chunks * bfeats.shape[0])
    kc = min(kc, bcull.num_chunks)
    trows, pc, pg, _, _ = tlas_candidates(bfeats, btables, mg, large.MC,
                                          npairs, kc, pblk)
    bb = bounds_from_feats(bfeats)
    pairs = (pc, pg, route_pairs(*bb, btables, large.S, npairs, kc)[2])
    tla = phase_a_check("phase A routed 10M", torch.cat(bb, dim=1), btables,
                        large.S, pair_row_budgets(bcull, mg, large.MC),
                        pairs)
    results["phase_a_cuda"].update(
        {f"{k}_10m": tla[k] for k in ("ms", "plain_ms", "bound_ms")})
    skewed_phase_a(tables, btables, dev)
    rargs = (pc, pg, trows, bfeats, bcull.prims, bcull.leaf_size,
             bcull.leaves_per_chunk, bcull.leaves_per_group)
    compare_routed("routed 10M", rargs)
    leaf_rows("routed 10M rows", trows, bcull.leaves_per_group)
    npr, nsub = trows.shape[:2]
    log(f"routed 10M: keys {npr * nsub * bfeats.shape[2] * 8} bytes ({npr} "
        f"pairs x {nsub} subpackets x {bfeats.shape[2]} rays x 8)")
    routed_ms = time_cuda(routed_cuda, *rargs)
    routed_plain_ms = time_cuda(
        lambda *a: routed_plain(*a, pair_elems=PLAIN_ELEMS), *rargs,
        warmup=1, iters=1)
    rb, rby = walk_bound("routed 10M", bfeats, trows, bcull,
                         walked_leaves(trows, bcull.leaves_per_group),
                         trows.shape[0] * bfeats.shape[2]
                         * bfeats.shape[1] * 8, extra=(pc, pg))
    log(f"routed 10M: cuda {routed_ms:.4f} ms, plain {routed_plain_ms:.4f} "
        f"ms, bound {rb:.4f} ms ({rby})")
    results["routed_cuda"] = dict(
        ms=routed_ms, plain_ms=routed_plain_ms, library_ms=None,
        bound_ms=rb, bound_by=rby, max_abs_err=0,
        launches=b_launches["routed_cuda"])
    log_beside_expanded("routed 10M", routed_ms)
    ofeats, _ = large.prep(boo, bod)
    otrows, opc, opg, _, oovf = tlas_candidates(ofeats, btables, mg,
                                                large.MC, npairs, kc, pblk)
    oargs = (opc, opg, otrows, ofeats, bcull.prims, bcull.leaf_size,
             bcull.leaves_per_chunk, bcull.leaves_per_group)
    compare_routed(f"routed 10M off the origin (routing overflow "
                   f"{bool(oovf)})", oargs)
    log(f"routed 10M off the origin: cuda "
        f"{time_cuda(routed_cuda, *oargs):.4f} ms")
    del boo, bod, ofeats, otrows, oargs

    # -- 7a. phase A at several chunks on the render's tables ------------------
    rows = render_phase_a(dev)
    results["phase_a_cuda"].update(
        {f"{k}_chunks": rows[k] for k in ("ms", "plain_ms", "bound_ms")})

    # -- 7. the render slice at full size -------------------------------------
    render_slice(dev, results, comp)

    # -- 7c. the differentiable path on the 100k scene ----------------------
    diff_launches = diff_slice(dev, scene, tables, o, d, comp)
    results["compact_cuda"]["launches"] += diff_launches

    # -- 7d. the soft evaluation's kernel at grad_131k's shapes -------------
    soft_slice(dev, scene, results)

    # -- 7b. the compactor over the main paths -------------------------------
    comp.summary()

    # -- 8. the bench lines --------------------------------------------------
    log(json.dumps(headline.measure(scene, tables, o, d, build_ms)))
    log(json.dumps(large.measure(btables, bo, bd, lbvh_ms, tables_ms)))
    del btables, bcull, bo, bd, bfeats, trows, rargs
    torch.cuda.empty_cache()

    # -- 8b, 8c. the sweep, the render flags, debug and viz -------------------
    sweep_slice(comp)
    tools_slice(scene, bvh16, o, d)

    # -- 8d. the distribution at world size 1 -------------------------------
    dist_slice(dev, scene, tables, o, d)

    # -- 9. results ----------------------------------------------------------
    meta = {
        "leafcull_cuda": ("tracer_torch/csrc/leafcull.cu",
                          "tracer/kernels/leafcull.py:515"),
        "compact_cuda": ("tracer_torch/csrc/compact.cu",
                         "tracer/kernels/conecull.py:414"),
        "anyhit_cuda": ("tracer_torch/csrc/anyhit.cu",
                        "tracer/kernels/leafcull.py:829"),
        "routed_cuda": ("tracer_torch/csrc/routed.cu",
                        "tracer/kernels/tlas.py:260"),
        "traverse_cuda": ("tracer_torch/csrc/traverse.cu",
                          "tracer/kernels/traverse_pallas.py:126"),
        "tilecull_cuda": ("tracer_torch/csrc/tilecull.cu",
                          "tracer/kernels/tilecull.py:149"),
        "conecull_cuda": ("tracer_torch/csrc/conecull.cu",
                          "tracer/kernels/conecull.py:562"),
        "cull_cuda": ("tracer_torch/csrc/cull.cu",
                      "tracer/kernels/cull_pallas.py:57"),
        "phase_a_cuda": ("tracer_torch/csrc/phase_a.cu",
                         "none (XLA operations: tracer/kernels/conecull.py "
                         "cone_candidates, tracer/kernels/tlas.py "
                         "tlas_candidates)"),
        "prep_cuda": ("tracer_torch/csrc/prep.cu",
                      "none (XLA operations: tracer/kernels/leafcull.py:475 "
                      "prep_feats_bucketed)"),
        "soft_cuda": ("tracer_torch/csrc/soft.cu",
                      "none (XLA operations: tracer/diff/sparse.py, the "
                      "soft composite and its autodiff)"),
    }
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    log(f"chip_smoke took {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         **{k: results[name][k] for k in keys},
         **{k: v for k, v in results[name].items()
            if k.endswith(("_10m", "_chunks", "_path"))}}
        for name, (src, rep) in meta.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
