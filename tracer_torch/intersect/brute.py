"""Brute-force closest hit over all spheres: the correctness oracle.

PyTorch counterpart of ``tracer/intersect/brute.py`` (the ``bvh == NULL``
path of the reference's ``trace_ray``, src/renderer.c:36-44). Ties break to
the lowest sphere index, like the reference's first-strictly-smaller scan.
"""

from __future__ import annotations

import torch
from torch import Tensor

from tracer_torch.core.types import Ray, HitRecord
from tracer_torch.intersect.sphere import (EPSILON, ray_sphere_t,
                                           hit_record_from_t)
from tracer_torch.scene.scene import Scene

_BIG = 3.0e38


def nearest_hit_brute(rays: Ray, scene: Scene) -> HitRecord:
    """Closest hit for a batch of rays, dense O(B*N).

    rays: batch shape (...,); returns a HitRecord with the same batch shape.
    """
    batch_shape = rays.batch_shape
    o = rays.origin.reshape(-1, 1, 3)
    d = rays.direction.reshape(-1, 1, 3)
    t = ray_sphere_t(o, d, scene.centers[None, :, :], scene.radii[None, :])
    idx = torch.argmin(t, dim=-1)                    # first minimum
    t_best = torch.gather(t, 1, idx[:, None])[:, 0]
    flat = Ray(origin=o[:, 0, :], direction=d[:, 0, :])
    rec = hit_record_from_t(flat, t_best, idx.to(torch.int32), scene.centers)
    return rec.reshape(batch_shape)


def brute_t_fast(o: Tensor, d: Tensor, centers: Tensor, radii: Tensor,
                 block: int = 8192):
    """(t, idx) closest hit, dense O(B*N) over ``block``-ray slices.

    Per-sphere attributes are rows (cx, cy, cz, |c|^2 - r^2) and per-ray
    scalars columns; the quadratic is the kernels' u-form (u = oc.d +
    sqrt(disc), t = -u/a), algebraically the reference's near root
    (src/hit.c:19-39). Equal t means equal u, and argmax returns the first
    maximum: the lowest sphere index wins ties. t is +inf and idx -1 on miss.
    """
    cx, cy, cz = centers[:, 0][None], centers[:, 1][None], centers[:, 2][None]
    ccr = (centers[:, 0] * centers[:, 0] + centers[:, 1] * centers[:, 1]
           + centers[:, 2] * centers[:, 2] - radii * radii)[None]
    ts, idxs = [], []
    for i in range(0, o.shape[0], block):
        ob, db = o[i:i + block], d[i:i + block]
        ox, oy, oz = ob[:, 0:1], ob[:, 1:2], ob[:, 2:3]
        dx, dy, dz = db[:, 0:1], db[:, 1:2], db[:, 2:3]
        od = ox * dx + oy * dy + oz * dz
        oo = ox * ox + oy * oy + oz * oz
        a = dx * dx + dy * dy + dz * dz
        m1 = dx * cx + dy * cy + dz * cz              # c.d     (blk, N)
        oc = ox * cx + oy * cy + oz * cz              # o.c     (blk, N)
        bp = od - m1                                  # oc.d
        cq = oo - 2.0 * oc + ccr                      # |oc|^2 - r^2
        disc = bp * bp - a * cq
        u = bp + torch.sqrt(torch.clamp(disc, min=0.0))
        ok = (disc > 0.0) & (u < -EPSILON * a)
        uv = torch.where(ok, u, torch.full_like(u, -_BIG))
        ubest, idx = torch.max(uv, dim=1)
        hit = ubest > -_BIG
        ts.append(torch.where(hit, -ubest / a[:, 0],
                              torch.full_like(ubest, float("inf"))))
        idxs.append(torch.where(hit, idx, torch.full_like(idx, -1))
                    .to(torch.int32))
    return torch.cat(ts), torch.cat(idxs)
