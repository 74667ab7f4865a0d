"""Ray-AABB slab test.

PyTorch counterpart of ``tracer/intersect/aabb.py`` (reference
``ray_aabb_intersect``, src/hit.c:49-82). A zero direction component gets
the finite stand-in 3e38 for 1/d, which makes that slab a pass-through
without the NaN that 0/0 gives when the origin lies on the slab plane.
Acceptance is ``tmax >= tmin && tmax > EPSILON``.
"""

from __future__ import annotations

import torch
from torch import Tensor

HUGE = 3.0e38  # finite stand-in for the +/-inf slab


def safe_inv_dir(direction: Tensor) -> Tensor:
    """1/d, with 3e38 where a component is zero."""
    zero = direction == 0.0
    return torch.where(zero, torch.full_like(direction, HUGE),
                       1.0 / torch.where(zero, torch.ones_like(direction),
                                         direction))


def ray_aabb_interval(origin: Tensor, inv_dir: Tensor, box_min: Tensor,
                      box_max: Tensor):
    """Slab interval (tmin, tmax); broadcasts over batch shapes of
    ``(..., 3)`` operands."""
    t1 = (box_min - origin) * inv_dir
    t2 = (box_max - origin) * inv_dir
    tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
    tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
    return tmin, tmax
