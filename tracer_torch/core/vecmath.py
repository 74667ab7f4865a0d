"""Batched 3-vector math over ``(..., 3)`` tensors.

PyTorch counterpart of ``tracer/core/vecmath.py`` (the reference's vec3
helpers, src/vec3.c:17-73): elementwise over any batch shape, components in
the trailing axis.
"""

from __future__ import annotations

import torch
from torch import Tensor


def dot(a: Tensor, b: Tensor) -> Tensor:
    """Batched dot product; reference ``vec3_dot`` (src/vec3.c:25-27),
    summed as (x + y) + z on every device: the order torch's CPU sum takes
    and the CUDA kernels spell, which a CUDA reduction does not promise."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] \
        + a[..., 2] * b[..., 2]


def length(a: Tensor) -> Tensor:
    """Euclidean norm; reference ``vec3_len`` (src/vec3.c:71-73)."""
    return torch.sqrt(dot(a, a))


def normalize(a: Tensor) -> Tensor:
    """Normalize with the reference's zero-guard (src/vec3.c:20-23): a zero
    vector normalizes to zero, not NaN. Double-where form keeps the backward
    pass NaN-free."""
    d2 = dot(a, a)[..., None]
    zero = d2 == 0.0
    len_ = torch.sqrt(torch.where(zero, torch.ones_like(d2), d2))
    return torch.where(zero, torch.zeros_like(a), a / len_)


def cross(a: Tensor, b: Tensor) -> Tensor:
    """Cross product; reference ``vec3_cross`` (src/vec3.c:37-43)."""
    return torch.linalg.cross(a, b, dim=-1)


def reflect(v: Tensor, n: Tensor) -> Tensor:
    """Mirror reflection; reference ``vec3_reflect`` (src/vec3.c:46-49)."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv: Tensor, n: Tensor, etai_over_etat) -> Tensor:
    """Snell refraction; reference ``vec3_refract`` (src/vec3.c:51-62)."""
    cos_theta = torch.clamp(dot(-uv, n), max=1.0)[..., None]
    r_out_perp = etai_over_etat * (uv + cos_theta * n)
    r_out_parallel = -torch.sqrt(
        torch.abs(1.0 - dot(r_out_perp, r_out_perp)))[..., None] * n
    return r_out_perp + r_out_parallel
