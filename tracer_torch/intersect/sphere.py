"""Vectorized ray-sphere intersection with the reference's exact semantics.

PyTorch counterpart of ``tracer/intersect/sphere.py`` (reference
``ray_sphere_intersect``, src/hit.c:19-39):
  - quadratic a = d.d, b = 2 oc.d, c = oc.oc - r^2; disc = b^2 - 4ac
  - accept only when disc > 0 (grazing disc == 0 is a miss)
  - only the NEAR root t = (-b - sqrt(disc)) / 2a; a ray starting inside a
    sphere misses it
  - accept only t > EPSILON (1e-6)
Misses return t = +inf so results compose with min-reductions.
"""

from __future__ import annotations

import torch
from torch import Tensor

from tracer_torch.core import vecmath
from tracer_torch.core.types import Ray, HitRecord

EPSILON = 1e-6  # include/Custom/constants.h:6


def ray_sphere_t(origin: Tensor, direction: Tensor, center: Tensor,
                 radius: Tensor, eps: float = EPSILON) -> Tensor:
    """Hit distance t, +inf on miss. Broadcasts over any batch shape:
    origin/direction ``(..., 3)`` against center ``(..., 3)``/radius ``(...,)``.
    """
    oc = origin - center
    a = vecmath.dot(direction, direction)
    b = 2.0 * vecmath.dot(oc, direction)
    c = vecmath.dot(oc, oc) - radius * radius
    disc = b * b - 4.0 * a * c
    # Miss lanes substitute 1.0 under the sqrt so a backward pass sees a
    # finite local derivative there; valid lanes keep the reference math.
    pos = disc > 0.0
    t = (-b - torch.sqrt(torch.where(pos, disc, torch.ones_like(disc)))) \
        / (2.0 * torch.clamp(a, min=1e-30))
    valid = pos & (t > eps)
    return torch.where(valid, t, torch.full_like(t, float("inf")))


def hit_record_from_t(rays: Ray, t: Tensor, index: Tensor,
                      centers: Tensor) -> HitRecord:
    """Assemble a HitRecord from per-ray (t, sphere index).

    point = o + t*d, normal = normalize(point - center) (src/hit.c:32-34).
    """
    hit = torch.isfinite(t)
    t_safe = torch.where(hit, t, torch.zeros_like(t))
    point = rays.at(t_safe)
    center = centers[torch.clamp(index, min=0).long()]
    normal = vecmath.normalize(point - center)
    return HitRecord(
        t=torch.where(hit, t, torch.full_like(t, float("inf"))),
        index=torch.where(hit, index, torch.full_like(index, -1)),
        hit=hit,
        point=point,
        normal=torch.where(hit[..., None], normal, torch.zeros_like(normal)),
    )
