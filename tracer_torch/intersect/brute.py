"""Brute-force closest hit and occlusion over all spheres: the oracles.

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


def any_hit_brute(rays: Ray, scene: Scene, t_max,
                  block: int = 8192) -> Tensor:
    """Occlusion oracle: True where ANY sphere blocks (EPSILON, t_max).

    "A closest hit would exist with t < t_max" under the reference
    acceptance rule (src/hit.c:19-39), dense O(B*N) over ``block``-ray
    slices. t_max is a scalar or one value per ray.
    """
    o = rays.origin.reshape(-1, 1, 3)
    d = rays.direction.reshape(-1, 1, 3)
    tm = torch.as_tensor(t_max, dtype=torch.float32, device=o.device)
    tm = tm.reshape(-1, 1).expand(o.shape[0], 1)
    occ = [torch.any(ray_sphere_t(o[i:i + block], d[i:i + block],
                                  scene.centers[None, :, :],
                                  scene.radii[None, :]) < tm[i:i + block],
                     dim=-1)
           for i in range(0, o.shape[0], block)]
    if not occ:
        return torch.zeros(rays.batch_shape, dtype=torch.bool,
                           device=o.device)
    return torch.cat(occ).reshape(rays.batch_shape)


def brute_t_fast(o: Tensor, d: Tensor, centers: Tensor, radii: Tensor,
                 block: int = 8192):
    """(t, idx) closest hit, dense O(B*N) over ``block``-ray slices.

    Per-sphere attributes are rows and per-ray scalars columns; the
    quadratic is the walks' (``leafcull.ray_prim_u``): the reference's sums
    on oc = o - c (src/hit.c:19-39), halved, so u = oc.d + sqrt(disc) and
    t = -u/a is its near root in the reference's roundings. Equal t means
    equal u, and argmax returns the first maximum: the lowest sphere index
    wins ties. t is +inf and idx -1 on miss.
    """
    cx, cy, cz = centers[:, 0][None], centers[:, 1][None], centers[:, 2][None]
    rsq = (radii * radii)[None]
    ts, idxs = [], []
    for i in range(0, o.shape[0], block):
        ob, db = o[i:i + block], d[i:i + block]
        ox, oy, oz = ob[:, 0:1], ob[:, 1:2], ob[:, 2:3]
        dx, dy, dz = db[:, 0:1], db[:, 1:2], db[:, 2:3]
        a = dx * dx + dy * dy + dz * dz
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz     # oc      (blk, N)
        bp = ocx * dx + ocy * dy + ocz * dz           # oc.d
        cq = ocx * ocx + ocy * ocy + ocz * ocz - rsq  # |oc|^2 - r^2
        del ocx, ocy, ocz
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


def nearest_hit_brute_fast(rays: Ray, scene: Scene,
                           block: int = 8192) -> HitRecord:
    """HitRecord over :func:`brute_t_fast`: the dense path the renderer
    takes at <= 4000 spheres. The winning id comes from the dense sweep;
    t is recomputed from it with the reference formulation, so autograd
    reaches the sphere centers and radii as in the kernel paths."""
    batch_shape = rays.batch_shape
    o = rays.origin.reshape(-1, 3)
    d = rays.direction.reshape(-1, 3)
    with torch.no_grad():
        _, idx = brute_t_fast(o, d, scene.centers, scene.radii, block=block)
    return record_from_ids(o, d, idx, scene).reshape(batch_shape)


def record_from_ids(o: Tensor, d: Tensor, idx: Tensor,
                    scene: Scene) -> HitRecord:
    """HitRecord of flat rays from their winning sphere ids (-1 on miss):
    t recomputed with ``ray_sphere_t`` so gradients flow to the scene."""
    safe = torch.clamp(idx, min=0).long()
    t = ray_sphere_t(o, d, scene.centers[safe], scene.radii[safe])
    t = torch.where(idx >= 0, t, torch.full_like(t, float("inf")))
    return hit_record_from_t(Ray(origin=o, direction=d), t,
                             idx.to(torch.int32), scene.centers)
