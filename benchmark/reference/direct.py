"""The direct-lit pixel: camera ray, closest hit, one shadow ray, shading.

The renderer's direct-lighting mode (BASELINE configuration 3: primary
plus shadow rays), as ``trace_direct`` in the port describes it. The
reference C program has no light (``create_light_sphere`` is declared and
never defined, include/Custom/sphere.h:18), so the light's position,
intensity and ambient term are the configuration's. A pixel's camera ray
is ``path.camera_rays``'; its closest hit is the brute-force scan of
``sphere.closest_hit`` (src/hit.c:19-39); a hit at p on sphere c casts one
shadow ray from p along the unnormalised light - p, occluded where any
sphere's near root t lies in (EPSILON, 1), that is between p and the
light; a hit's colour is albedo * (ambient + intensity * visible *
max(0, n.l)) with n = normalize(p - c) and l = normalize(light - p); a
miss takes the sky of the camera ray's direction. The colour is clamped
to [0, 1].

Departures from ``trace_direct``'s description: none in what is computed.
The shadow test is a closest hit over every sphere read as "t < 1"
(an any-hit needs no order), and l is normalised with ``sphere.normalize``
where the port divides by the clamped length: the two differ in rounding
only.
"""

from __future__ import annotations

import torch
from torch import Tensor

from benchmark.reference.path import sky
from benchmark.reference.sphere import closest_hit, dot, normalize


def occluded(p: Tensor, to_light: Tensor, centers: Tensor, radii: Tensor,
             dtype=torch.float32) -> Tensor:
    """(n,) bool: some sphere's near root lies in (EPSILON, 1) along
    p + t * to_light, computed in ``dtype``."""
    t, _ = closest_hit(p, to_light, centers, radii, dtype=dtype)
    return t < 1.0


def shade(o: Tensor, d: Tensor, centers: Tensor, radii: Tensor,
          albedo: Tensor, light, intensity: float, ambient: float,
          dtype=torch.float32) -> Tensor:
    """(n, 3) f32 colour of n camera rays o, d (n, 3), every step in
    ``dtype``."""
    c = centers.to(dtype)
    o, d = o.to(dtype), d.to(dtype)
    t, idx = closest_hit(o, d, c, radii, dtype=dtype)
    hit = idx >= 0
    col = sky(d)
    ih = idx[hit]
    p = o[hit] + t[hit].to(dtype)[:, None] * d[hit]
    n = normalize(p - c[ih])
    to_light = torch.as_tensor(light, dtype=dtype, device=o.device) - p
    ndotl = torch.clamp(dot(n, normalize(to_light)), min=0.0)
    blocked = occluded(p, to_light, c, radii, dtype=dtype)
    vis = torch.where(blocked, torch.zeros_like(ndotl), ndotl)
    col[hit] = albedo.to(dtype)[ih] * (ambient + intensity * vis)[:, None]
    return torch.clamp(col.float(), 0.0, 1.0)
