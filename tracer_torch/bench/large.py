"""The large-scene query: 10M spheres through the TLAS-routed path.

Reproduces the JAX harness's 10M sweep row (``tracer/bench/harness.py``,
``run_sweep``) at full size: N = 10,000,000 spheres of r = 0.5 uniform in a
1000^3 cube, 131,072 origin rays with uniform-cube directions (the
``run_sweep`` default), the device LBVH with leaf size 32 (the harness
builds on the device from 5M spheres up, harness.py:188), S = 8, SP = 128,
cell_bits = 8, and the harness's budgets for the chunk count the tables
give (:func:`budgets`). Nothing is cut.

The metric ``lbvh_10m_tlas_mrays`` is B over the CUDA-event time of the
whole query, prep to raw-order (t, slot). The line also carries the stage
times (prep, routing + phase A, walk, merge), the device LBVH build time,
the host table build time (set-up, like ``bvh_build_ms``), the chunk and
pair counts, overflow, hit fraction, the kernels' launches per query, the
query's peak device memory (``torch.cuda.max_memory_allocated`` over one
query, with the scene and tables already resident, and the part above
them) and the card's name.

Run ``python -m tracer_torch.bench.large``: it prints one JSON line and
exits non-zero on any failure, including the absence of a CUDA device.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from tracer_torch.bench.profile import profile_calls
from tracer_torch.bench.timing import time_cuda
from tracer_torch.bvh.device import build_bvh_device
from tracer_torch.kernels import _lib
from tracer_torch.kernels.conecull import (bounds_from_feats,
                                           build_cone_tables,
                                           kernel_order_dest)
from tracer_torch.kernels.leafcull import prep_feats_bucketed
from tracer_torch.kernels.tlas import (nearest_hit_tlas_feats, route_pairs,
                                       routed_call, tlas_candidates,
                                       tlas_merge)
from tracer_torch.scene.scene import benchmark_scene

METRIC = "lbvh_10m_tlas_mrays"
N_SPHERES = 10_000_000
WORLD = 1000.0
B = 131_072
S = 8
SP = 128
CELL_BITS = 8
LEAF_SIZE = 32
MC = 119
SCENE_SEED, RAY_SEED = 1, 0


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def budgets(n: int, num_chunks: int, num_rays: int = B):
    """Phase-A and routing budgets of the JAX harness for a scene of n
    spheres in ``num_chunks`` table chunks (harness.py:251-275, budgets
    from its measured 10M and 100M routing). Returns (max_groups, npairs,
    kc, pair_block)."""
    mg = 64 if n <= 300_000 else (128 if n <= 3_000_000 else 256)
    g_est = (num_rays + 256 * SP) // (S * SP) + 1
    if num_chunks <= 32:
        pair_mult, kc, pair_block = 24, 48, 8192
    elif num_chunks <= 256:
        pair_mult, kc, pair_block = 40, 128, 8192
    else:
        pair_mult, kc, pair_block = 144, 512, 4096
    npairs = min(num_chunks * g_est, max(4096, pair_mult * g_est))
    kc = min(num_chunks, kc)
    if num_chunks > 32:
        mg = 32             # a per-chunk group budget
    return mg, npairs, kc, pair_block


def benchmark_inputs(device, n_spheres: int = N_SPHERES, n_rays: int = B,
                     world: float = WORLD):
    """Scene, device LBVH, cone tables and origin rays, all seeded.

    Returns (scene, tables, origins, directions, bvh_build_device_ms,
    tables_ms): the LBVH build on CUDA events, the table build (numpy on
    the host plus the prim gather on the device) on the host clock.
    """
    scene = benchmark_scene(torch.Generator().manual_seed(SCENE_SEED),
                            n_spheres, world_size=world, device=device)
    build_ms = time_cuda(build_bvh_device, scene.centers, scene.radii,
                         LEAF_SIZE, warmup=1, iters=3)
    bvh = build_bvh_device(scene.centers, scene.radii, leaf_size=LEAF_SIZE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tables = build_cone_tables(scene, bvh)
    torch.cuda.synchronize()
    tables_ms = (time.perf_counter() - t0) * 1e3
    rng = np.random.default_rng(RAY_SEED)
    d = rng.uniform(-1, 1, (n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    direction = torch.as_tensor(d, device=device)
    return (scene, tables, torch.zeros_like(direction), direction, build_ms,
            tables_ms)


def prep(o, d):
    """Prep stage: (feats, dest in the walk's output order)."""
    feats, dest = prep_feats_bucketed(o, d, S, SP, cell_bits=CELL_BITS)
    return feats, kernel_order_dest(dest, S, SP)


def query(o, d, tables, budget):
    """The whole query: (t, slot, dest, overflow); ray i's hit is
    (t[dest[i]], slot[dest[i]]), slot -1 and t +inf on miss."""
    mg, npairs, kc, pair_block = budget
    feats, dest = prep(o, d)
    t, slot, overflow = nearest_hit_tlas_feats(
        feats, tables, mg, MC, npairs, kc, pair_block)
    return t, slot, dest, overflow


def measure(tables, o, d, build_ms: float, tables_ms: float,
            n_spheres: int = N_SPHERES) -> dict:
    """Time the query and its stages; returns the large-scene record."""
    b = o.shape[0]
    cull = tables.cull
    budget = budgets(n_spheres, cull.num_chunks, b)
    mg, npairs, kc, pair_block = budget
    ms = time_cuda(query, o, d, tables, budget)
    torch.cuda.synchronize(o.device)
    torch.cuda.reset_peak_memory_stats(o.device)
    resident = torch.cuda.memory_allocated(o.device)
    before = _lib.launches.copy()
    t, _, dest, overflow = query(o, d, tables, budget)
    torch.cuda.synchronize(o.device)
    peak = torch.cuda.max_memory_allocated(o.device)
    launches = {k: _lib.launches[k] - before[k]
                for k in ("routed_cuda", "compact_cuda")}
    hit_fraction = torch.isfinite(t[dest]).float().mean().item()

    feats, _ = prep(o, d)
    npairs = min(npairs, cull.num_chunks * feats.shape[0])
    kc = min(kc, cull.num_chunks)
    routed = int(route_pairs(*bounds_from_feats(feats), tables, S, npairs,
                             kc)[2].sum())
    prep_ms = time_cuda(prep, o, d)
    phase_a_ms = time_cuda(tlas_candidates, feats, tables, mg, MC, npairs,
                           kc, pair_block)
    rows, pair_c, pair_gb, merge_pos, _ = tlas_candidates(
        feats, tables, mg, MC, npairs, kc, pair_block)
    walk_args = (pair_c, pair_gb, rows, feats, cull.prims, cull.leaf_size,
                 cull.leaves_per_chunk, cull.leaves_per_group)
    walk_ms = time_cuda(routed_call, *walk_args)
    t_p, slot_p = routed_call(*walk_args)
    merge_ms = time_cuda(tlas_merge, t_p, slot_p, merge_pos)
    prof = profile_calls(query, o, d, tables, budget)
    value = b / (ms * 1e-3) / 1e6
    log(f"query {ms:.3f} ms -> {value:.3f} Mrays/s (prep {prep_ms:.3f}, "
        f"route + phase A {phase_a_ms:.3f}, walk {walk_ms:.3f}, merge "
        f"{merge_ms:.3f} ms); {routed} of {npairs} pairs routed")
    return {
        "metric": METRIC,
        "value": value,
        "unit": "Mrays/s",
        "path": "tlas_routed_cuda",
        "n_spheres": n_spheres,
        "rays": b,
        "chunks": cull.num_chunks,
        "max_groups": mg,
        "npairs": npairs,
        "pairs_routed": routed,
        "kc": kc,
        "pair_block": pair_block,
        "overflow": bool(overflow),
        "hit_fraction": hit_fraction,
        "prep_ms": prep_ms,
        "route_phase_a_ms": phase_a_ms,
        "walk_ms": walk_ms,
        "merge_ms": merge_ms,
        "bvh_build_device_ms": build_ms,
        "tables_ms": tables_ms,
        "launches": launches,
        "query_peak_mib": peak / 2 ** 20,
        "query_peak_above_resident_mib": (peak - resident) / 2 ** 20,
        "device_ms": prof["device_ms"],
        "idle_share": prof["idle_share"],
        "device_launches": prof["launches"],
        "device": torch.cuda.get_device_name(o.device),
    }


def main() -> int:
    if not torch.cuda.is_available():
        log("tracer_torch.bench.large needs a CUDA device")
        return 1
    _, tables, o, d, build_ms, tables_ms = benchmark_inputs(
        torch.device("cuda"))
    cull = tables.cull
    log(f"device LBVH {build_ms:.1f} ms; tables {tables_ms:.1f} ms: "
        f"{cull.num_chunks} chunk(s), {cull.num_real_leaves} leaves, "
        f"{cull.prims.numel() * 4 / 1e6:.1f} MB of prims")
    print(json.dumps(measure(tables, o, d, build_ms, tables_ms)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
