"""The headline measurement: closest-hit throughput at 100k spheres.

Closest hit for B = 512k rays against N = 100k spheres on the reference's
own benchmark distribution (spheres of r = 0.5 uniform in a 1000^3 cube,
rays from the origin with uniform-cube directions; src/benchmark.c:172-223,
283-332), end to end: prep (octahedral sort + cell bucketing + result-order
map), phase A (cone_candidates) and the leaf walk, on one CUDA device. The
reference CPU does 7.85 Mrays/s at this size (results/benchmark_data.txt:3).

Extras, as ``bench.py`` defines them: the shadow query (any-hit over the
segment (EPSILON, 500) for the same rays, prep with t_max inside the timed
call; ``shadow_mrays``, ``shadow_occluded_fraction``), and the device LBVH
(``bvh_build_device_ms``; ``lbvh_e2e_mrays``, the same query on cone tables
built from the LBVH tree with leaf size 32).

Run ``python -m tracer_torch.bench``: it prints one JSON line and exits
non-zero on any failure, including the absence of a CUDA device.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from tracer_torch.bench.timing import time_cuda
from tracer_torch.bvh.builder import build_bvh
from tracer_torch.bvh.device import build_bvh_device
from tracer_torch.kernels.conecull import (build_cone_tables,
                                           cone_candidates,
                                           kernel_order_dest,
                                           nearest_hit_hybrid_feats,
                                           occluded_hybrid_feats)
from tracer_torch.kernels.leafcull import leafcull_call, prep_feats_bucketed
from tracer_torch.scene.scene import benchmark_scene

METRIC = "bvh_closest_hit_throughput_100k_spheres_e2e"
BASELINE_MRAYS = 7.85  # reference BVH @ 100k spheres
N_SPHERES = 100_000
WORLD = 1000.0
B = 512 * 1024
S = 8               # subpackets per packet
SP = 128            # rays per subpacket (one cull frustum)
CELL_BITS = 9       # direction cells of the bucket pad
MG, MC = 64, 119    # phase A group / leaf-candidate budgets
LEAF_SIZE = 32
SCENE_SEED, RAY_SEED = 1, 0
SHADOW_T_MAX = 500.0


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def benchmark_inputs(device, n_spheres: int = N_SPHERES, n_rays: int = B,
                     world: float = WORLD, **table_args):
    """Scene, native SAH BVH, cone tables and origin rays, all seeded.

    Returns (scene, tables, origins, directions, bvh_build_ms).
    """
    scene = benchmark_scene(torch.Generator().manual_seed(SCENE_SEED),
                            n_spheres, world_size=world, device=device)
    t0 = time.perf_counter()
    bvh = build_bvh(scene.centers, scene.radii, leaf_size=LEAF_SIZE,
                    backend="native", device=device)
    build_ms = (time.perf_counter() - t0) * 1e3
    tables = build_cone_tables(scene, bvh, **table_args)
    rng = np.random.default_rng(RAY_SEED)
    d = rng.uniform(-1, 1, (n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    direction = torch.as_tensor(d, device=device)
    origin = torch.zeros_like(direction)
    return scene, tables, origin, direction, build_ms


def prep(o, d):
    """Prep stage: (feats, dest in the leaf walk's output order)."""
    feats, dest = prep_feats_bucketed(o, d, S, SP, cell_bits=CELL_BITS)
    return feats, kernel_order_dest(dest, S, SP)


def query(o, d, tables, max_groups: int = MG, max_candidates: int = MC):
    """The whole query: (t, slot, dest, overflow); ray i's hit is
    (t[dest[i]], slot[dest[i]]), slot -1 and t +inf on miss."""
    feats, dest = prep(o, d)
    t, slot, overflow = nearest_hit_hybrid_feats(feats, tables, max_groups,
                                                 max_candidates)
    return t, slot, dest, overflow


def shadow_query(o, d, tables, max_groups: int = MG,
                 max_candidates: int = MC):
    """The shadow query: (occ, dest, overflow); ray i is occluded over
    (EPSILON, SHADOW_T_MAX) when occ[dest[i]] is 1."""
    tm = torch.full((o.shape[0],), SHADOW_T_MAX, dtype=torch.float32,
                    device=o.device)
    feats, dest = prep_feats_bucketed(o, d, S, SP, cell_bits=CELL_BITS,
                                      t_max=tm)
    occ, overflow = occluded_hybrid_feats(feats, tables, max_groups,
                                          max_candidates)
    return occ, kernel_order_dest(dest, S, SP), overflow


def measure(scene, tables, o, d, build_ms: float) -> dict:
    """Time the query, its stages and the extras; returns the headline
    record."""
    b = o.shape[0]
    ms = time_cuda(query, o, d, tables)
    t, _, dest, overflow = query(o, d, tables)
    hit_fraction = torch.isfinite(t[dest]).float().mean().item()

    prep_ms = time_cuda(prep, o, d)
    feats, _ = prep(o, d)
    phase_a_ms = time_cuda(cone_candidates, feats, tables, MG, MC)
    cull = tables.cull
    rows = cone_candidates(feats, tables, MG, MC)[0]
    rows = rows.reshape(cull.num_chunks, feats.shape[0], S, rows.shape[-1])
    kernel_ms = time_cuda(leafcull_call, feats, rows, cull.prims,
                          cull.leaf_size, cull.leaves_per_chunk,
                          cull.leaves_per_group)
    value = b / (ms * 1e-3) / 1e6
    log(f"query {ms:.3f} ms -> {value:.2f} Mrays/s (prep {prep_ms:.3f}, "
        f"phase A {phase_a_ms:.3f}, kernel {kernel_ms:.3f} ms)")

    shadow_ms = time_cuda(shadow_query, o, d, tables)
    occ, sdest, s_overflow = shadow_query(o, d, tables)
    occluded = occ[sdest].float().mean().item()
    log(f"shadow {shadow_ms:.3f} ms -> {b / shadow_ms / 1e3:.2f} Mrays/s "
        f"(occluded {occluded:.4f})")

    build_device_ms = time_cuda(build_bvh_device, scene.centers,
                                scene.radii, LEAF_SIZE)
    ltables = build_cone_tables(scene, build_bvh_device(
        scene.centers, scene.radii, leaf_size=LEAF_SIZE))
    lbvh_ms = time_cuda(query, o, d, ltables)
    l_overflow = query(o, d, ltables)[3]
    log(f"device LBVH build {build_device_ms:.3f} ms; query on its tree "
        f"{lbvh_ms:.3f} ms -> {b / lbvh_ms / 1e3:.2f} Mrays/s")
    return {
        "metric": METRIC,
        "value": value,
        "unit": "Mrays/s",
        "vs_baseline": value / BASELINE_MRAYS,
        "path": "hybrid_feats_cuda",
        "overflow": bool(overflow),
        "hit_fraction": hit_fraction,
        "prep_ms": prep_ms,
        "phase_a_ms": phase_a_ms,
        "kernel_ms": kernel_ms,
        "bvh_build_ms": build_ms,
        "shadow_mrays": b / (shadow_ms * 1e-3) / 1e6,
        "shadow_occluded_fraction": occluded,
        "shadow_overflow": bool(s_overflow),
        "bvh_build_device_ms": build_device_ms,
        "lbvh_e2e_mrays": b / (lbvh_ms * 1e-3) / 1e6,
        "lbvh_overflow": bool(l_overflow),
        "device": torch.cuda.get_device_name(o.device),
    }


def main() -> int:
    if not torch.cuda.is_available():
        log("tracer_torch.bench needs a CUDA device")
        return 1
    device = torch.device("cuda")
    scene, tables, o, d, build_ms = benchmark_inputs(device)
    cull = tables.cull
    log(f"bvh build {build_ms:.1f} ms; tables: {cull.num_chunks} chunk(s), "
        f"{cull.num_real_leaves} leaves, "
        f"{cull.prims.numel() * 4 / 1e6:.1f} MB of prims")
    print(json.dumps(measure(scene, tables, o, d, build_ms)), flush=True)
    return 0
