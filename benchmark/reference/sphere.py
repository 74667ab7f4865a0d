"""Ray-sphere intersection and brute-force closest hit.

The reference's acceptance rule (``ray_sphere_intersect``,
src/hit.c:19-39): a = d.d, b = 2 oc.d, c = oc.oc - r^2, disc = b^2 - 4ac;
a hit needs disc > 0, only the near root t = (-b - sqrt(disc)) / 2a counts
and only when t > EPSILON. The closest hit is the smallest such t over all
spheres, ties to the lowest sphere index, as the reference's scan of every
sphere (src/renderer.c:36-44).
"""

from __future__ import annotations

import torch
from torch import Tensor

EPSILON = 1e-6  # include/Custom/constants.h:6


def dot(a: Tensor, b: Tensor) -> Tensor:
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) \
        + a[..., 2] * b[..., 2]


def normalize(a: Tensor) -> Tensor:
    """a / |a|, and 0 for a zero vector (src/vec3.c:20-23)."""
    d2 = dot(a, a)[..., None]
    zero = d2 == 0.0
    return torch.where(zero, torch.zeros_like(a),
                       a / torch.sqrt(torch.where(zero, torch.ones_like(d2),
                                                  d2)))


def ray_sphere_t(o: Tensor, d: Tensor, c: Tensor, r: Tensor) -> Tensor:
    """Hit distance, +inf on a miss; broadcasts rays (..., 3) against
    spheres (..., 3) and radii (...)."""
    oc = o - c
    a = dot(d, d)
    b = 2.0 * dot(oc, d)
    cc = dot(oc, oc) - r * r
    disc = b * b - 4.0 * a * cc
    pos = disc > 0.0
    t = (-b - torch.sqrt(torch.where(pos, disc, torch.ones_like(disc)))) \
        / (2.0 * a)
    return torch.where(pos & (t > EPSILON), t, torch.full_like(t, torch.inf))


def closest_hit(o: Tensor, d: Tensor, centers: Tensor, radii: Tensor,
                dtype=torch.float32, elements: int = 1 << 27):
    """(t (B,) f32, +inf on a miss; id (B,) int64, -1 on a miss) of rays
    o, d (B, 3) against every sphere, computed in ``dtype``, in blocks of
    rays of about ``elements`` ray-sphere pairs."""
    c = centers.to(dtype)[None]
    r = radii.to(dtype)[None]
    block = max(1, elements // max(1, centers.shape[0]))
    ts, ids = [], []
    for i in range(0, o.shape[0], block):
        t = ray_sphere_t(o[i:i + block, None].to(dtype),
                         d[i:i + block, None].to(dtype), c, r)
        best, idx = torch.min(t, dim=1)
        hit = torch.isfinite(best)
        ts.append(torch.where(hit, best.float(), torch.inf))
        ids.append(torch.where(hit, idx, -1))
    if not ts:
        return (torch.empty(0, device=o.device),
                torch.empty(0, dtype=torch.int64, device=o.device))
    return torch.cat(ts), torch.cat(ids)
