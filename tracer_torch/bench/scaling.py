"""Scaling harness: rays/s against the number of ranks.

PyTorch counterpart of ``tracer/bench/scaling.py``. Closest-hit throughput
of ``dist.shard.nearest_hit_sharded`` (scene replicated, rays sharded) on
sub-meshes of the first 1, 2, 4, ... ranks, with each count's efficiency
against the 1-rank run. Every rank of the world calls it: each sub-mesh is
made by all ranks in the same order, the ranks outside it wait at a
barrier, rank 0 times, and its rows are broadcast to every rank.

Each call is timed on its own: CUDA events on the card
(``timing.time_cuda``), the host clock on the CPU (``timing.time_host``).
A second, quarter-size batch splits the time T(n, B) = overhead(n) +
work(B) / n into its batch-proportional part, work = (T(B) - T(B/4)) * 4/3,
and the rest, overhead = T(B) - work (both clamped at 0).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from tracer_torch.bench.timing import time_cuda, time_host
from tracer_torch.core.types import Ray
from tracer_torch.dist.mesh import ensure_group, ray_mesh
from tracer_torch.dist.shard import nearest_hit_sharded


def measure_scaling(scene, rays: Ray, nearest_hit: Callable,
                    device_counts=None, reps: int = 3) -> list[dict]:
    """Time ``nearest_hit_sharded`` on growing sub-meshes.

    rays: a flat batch divisible by 4 times every rank count tested;
    ``nearest_hit(rays, scene)`` as ``nearest_hit_sharded`` takes it.
    Returns [{devices, ms, ms_quarter_batch, work_ms, overhead_ms,
    mrays_per_s, efficiency}, ...] on every rank.
    """
    dev = rays.origin.device
    world = ensure_group(dev)
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16, 32, 64, 128, 256)
                         if n <= world]
    clock = time_cuda if dev.type == "cuda" else time_host
    o = rays.origin.reshape(-1, 3)
    d = rays.direction.reshape(-1, 3)
    b = o.shape[0]
    quarter = Ray(origin=o[:b // 4], direction=d[:b // 4])
    full = Ray(origin=o, direction=d)
    rows = []
    base = None
    for n in device_counts:
        mesh = ray_mesh(n, dev)
        if mesh.get_coordinate() is not None:
            def fn(r):
                return nearest_hit_sharded(r, scene, mesh, nearest_hit)
            dt = clock(fn, full, warmup=1, iters=reps) / 1e3
            dtq = clock(fn, quarter, warmup=1, iters=reps) / 1e3
            work = max((dt - dtq) * 4.0 / 3.0, 0.0)
            mrays = b / dt / 1e6
            if base is None:
                base = mrays
            rows.append({
                "devices": n,
                "ms": dt * 1e3,
                "ms_quarter_batch": dtq * 1e3,
                "work_ms": work * 1e3,
                "overhead_ms": max(dt - work, 0.0) * 1e3,
                "mrays_per_s": mrays,
                "efficiency": mrays / (base * n),
            })
        dist.barrier()
    out = [rows]
    dist.broadcast_object_list(out, src=0)
    return out[0]
