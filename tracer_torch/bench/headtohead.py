"""Head-to-head of every closest-hit generation on the card.

PyTorch counterpart of ``tools/headtohead.py``. On the headline inputs
(``bench.headline``: N = 100k spheres of r = 0.5 in a 1000^3 cube, B = 512k
origin rays, scene seed 1, ray seed 0) it times each generation end to end
as a caller runs it: the rays ordered the way that generation wants, then
its checked entry point (the budget doubled until nothing overflows):

* ``packet`` -- the packet walk (``nearest_hit_bvh_packets``, no budget),
  direction-sorted rays, 16-prim leaves;
* ``cull`` -- the packet cull (``nearest_hit_cull_checked`` from K = 128),
  direction-sorted rays, 16-prim leaves;
* ``tilecull`` -- the tile cull (``nearest_hit_tilecull_checked`` from
  K = 64), octahedral-sorted rays, 16-prim leaves;
* ``leafwalk`` -- prep, phase A and the leaf walk
  (``nearest_hit_leafcull_checked``, S = 8, SP = 128, MG 64 / MC 119), at
  leaf sizes 32 and 16;
* ``phase_b`` -- ``prep_rays_bucketed``, then phase A, the cones and the
  cone-cull walk (``nearest_hit_conecull_checked``, the same budgets), at
  leaf sizes 32 and 16.

One JSON line per generation: ms (CUDA events, mean of ``ITERS`` calls
after a warm-up), Mrays/s, escalations, hit fraction. The phase-B lines add
the walk kernels' own times on the rows of the budget the query settled on
(``walk_ms`` for ``conecull_cuda``, ``leafcull_walk_ms`` for
``leafcull_cuda`` on the same rows) and the share of walked prims that
survive the cone test. The JAX docstring's claim that phase B wins
when leaves shrink is what ``walk_ms`` against ``leafcull_walk_ms`` at leaf
16 answers for this card.

Run ``python -m tracer_torch.bench.headtohead [N_SPHERES] [B_RAYS]``; it
exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import sys

import torch

from tracer_torch.bench import headline
from tracer_torch.bench.timing import time_cuda
from tracer_torch.bvh.builder import build_bvh
from tracer_torch.core.sort import (prep_rays_bucketed,
                                    sort_rays_by_direction,
                                    sort_rays_octahedral)
from tracer_torch.core.types import Ray
from tracer_torch.intersect.cull import build_leaf_table
from tracer_torch.kernels.conecull import (CONE_FEAT, bounds_from_feats,
                                           build_cone_tables, cone_candidates,
                                           cone_from_feats, conecull_cuda,
                                           nearest_hit_conecull_checked)
from tracer_torch.kernels.cull import nearest_hit_cull_checked
from tracer_torch.kernels.leafcull import (leafcull_cuda,
                                           nearest_hit_leafcull_checked,
                                           pack_ray_features)
from tracer_torch.kernels.tilecull import nearest_hit_tilecull_checked
from tracer_torch.kernels.traverse import nearest_hit_bvh_packets, pack_bvh

ITERS = 3
CULL_K, TILE_K = 128, 64
S, SP, CELL_BITS, MG, MC = (headline.S, headline.SP, headline.CELL_BITS,
                            headline.MG, headline.MC)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def settled_budgets(tables, escalations: int):
    """(max_groups, max_candidates) after the checked query's doublings."""
    cull = tables.cull
    return (min(MG << escalations, cull.num_groups),
            min(MC << escalations, cull.leaves_per_chunk))


def walk_stats(padded: Ray, tables, escalations: int) -> dict:
    """Both walk kernels on the rows of the settled budgets: their times,
    and the cone test's survivors over the walked prims."""
    cull = tables.cull
    feats, g, _ = pack_ray_features(padded.origin, padded.direction, S, SP)
    rows, _, _ = cone_candidates(feats, tables,
                                 *settled_budgets(tables, escalations))
    rows = rows.reshape(cull.num_chunks, g, S, rows.shape[-1])
    cones = cone_from_feats(feats, *bounds_from_feats(feats),
                            tables.r_max).reshape(g, S, CONE_FEAT)
    args = (cull.prims, cull.leaf_size, cull.leaves_per_chunk,
            cull.leaves_per_group)
    _, _, kept = conecull_cuda(feats, rows, cones, *args)
    nc = rows[..., 0].long()
    walked = (nc.clamp(min=0) + (-nc).clamp(min=0) * cull.leaves_per_group) \
        .sum().item() * cull.leaf_size
    return {
        "walk_ms": time_cuda(conecull_cuda, feats, rows, cones, *args),
        "leafcull_walk_ms": time_cuda(leafcull_cuda, feats, rows, *args),
        "walked_prims": walked,
        "survivor_share": kept.sum().item() / max(walked, 1),
    }


def line(generation: str, leaf_size: int, b: int, ms: float, hit,
         escalations: int, **extra) -> dict:
    out = {"generation": generation, "leaf_size": leaf_size, "ms": ms,
           "mrays": b / (ms * 1e-3) / 1e6, "escalations": escalations,
           "hit_fraction": hit.float().mean().item(), **extra,
           "device": torch.cuda.get_device_name(0)}
    print(json.dumps(out), flush=True)
    return out


def measure(n_spheres: int = headline.N_SPHERES,
            n_rays: int = headline.B) -> list:
    dev = torch.device("cuda")
    scene, tables32, o, d, _ = headline.benchmark_inputs(
        dev, n_spheres=n_spheres, n_rays=n_rays)
    rays = Ray(origin=o, direction=d)
    b = o.shape[0]
    out = []

    bvh16 = build_bvh(scene.centers, scene.radii, leaf_size=16,
                      backend="native", device=dev)
    packed = pack_bvh(scene, bvh16)
    table = build_leaf_table(bvh16)

    # Each generation returns (hit mask over the caller's rays, in the
    # order it sorted them; escalations).
    def packet():
        return nearest_hit_bvh_packets(sort_rays_by_direction(rays)[0],
                                       scene, packed).hit, 0

    def cull():
        rec, esc = nearest_hit_cull_checked(sort_rays_by_direction(rays)[0],
                                            scene, packed, table, CULL_K)
        return rec.hit, esc

    def tilecull():
        rec, esc = nearest_hit_tilecull_checked(
            sort_rays_octahedral(rays)[0], scene, packed, table, TILE_K)
        return rec.hit, esc

    for name, fn in (("packet", packet), ("cull", cull),
                     ("tilecull", tilecull)):
        hit, esc = fn()
        out.append(line(name, 16, b, time_cuda(fn, warmup=1, iters=ITERS),
                        hit, esc))

    tables16 = build_cone_tables(scene, bvh16)
    for leaf, tables in ((32, tables32), (16, tables16)):
        def leafwalk():
            rec, esc = nearest_hit_leafcull_checked(
                rays, scene, tables, MG, MC, subpackets=S, subpacket=SP,
                cell_bits=CELL_BITS)
            return rec.hit, esc

        def phase_b():
            padded, dest = prep_rays_bucketed(rays, SP, cell_bits=CELL_BITS)
            rec, esc = nearest_hit_conecull_checked(padded, scene, tables,
                                                    MG, MC, subpackets=S,
                                                    subpacket=SP)
            return rec.hit[dest], esc

        hit, esc = leafwalk()
        out.append(line("leafwalk", leaf, b,
                        time_cuda(leafwalk, warmup=1, iters=ITERS), hit, esc))
        hit, esc = phase_b()
        padded, _ = prep_rays_bucketed(rays, SP, cell_bits=CELL_BITS)
        out.append(line("phase_b", leaf, b,
                        time_cuda(phase_b, warmup=1, iters=ITERS), hit, esc,
                        **walk_stats(padded, tables, esc)))
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        log("tracer_torch.bench.headtohead needs a CUDA device")
        return 1
    measure(*(int(a) for a in argv[:2]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
