"""Rays and hit records as dataclasses of tensors.

PyTorch counterpart of ``tracer/core/types.py``: the reference's ``Ray``
(include/Custom/ray.h:5-8) and ``HitRecord`` (include/Custom/hit.h:8-14)
become struct-of-arrays containers over arbitrary batch shapes. The object
pointer is an int32 sphere index (-1 on miss).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import Tensor


@dataclass
class Ray:
    """A batch of rays; fields have shape ``(..., 3)``."""

    origin: Tensor
    direction: Tensor

    @property
    def batch_shape(self):
        return tuple(self.origin.shape[:-1])

    def at(self, t: Tensor) -> Tensor:
        """Point along the ray: ``origin + t * direction``."""
        return self.origin + t[..., None] * self.direction


@dataclass
class HitRecord:
    """A batch of closest-hit results; batch shape ``(...,)``.

    ``t`` is +inf on miss; ``index`` is the sphere index into the scene
    arrays (-1 on miss); ``hit`` is the boolean mask. ``point``/``normal``
    are only meaningful where ``hit`` is True.
    """

    t: Tensor           # (...,) f32, +inf on miss
    index: Tensor       # (...,) i32, -1 on miss
    hit: Tensor         # (...,) bool
    point: Tensor       # (..., 3) f32
    normal: Tensor      # (..., 3) f32

    @classmethod
    def miss(cls, batch_shape, device=None) -> "HitRecord":
        batch_shape = tuple(batch_shape)
        return cls(
            t=torch.full(batch_shape, float("inf"), dtype=torch.float32,
                         device=device),
            index=torch.full(batch_shape, -1, dtype=torch.int32,
                             device=device),
            hit=torch.zeros(batch_shape, dtype=torch.bool, device=device),
            point=torch.zeros((*batch_shape, 3), dtype=torch.float32,
                              device=device),
            normal=torch.zeros((*batch_shape, 3), dtype=torch.float32,
                               device=device),
        )

    def reshape(self, batch_shape) -> "HitRecord":
        """Same record with its flat batch reshaped to ``batch_shape``."""
        batch_shape = tuple(batch_shape)
        return HitRecord(
            t=self.t.reshape(batch_shape),
            index=self.index.reshape(batch_shape),
            hit=self.hit.reshape(batch_shape),
            point=self.point.reshape(*batch_shape, 3),
            normal=self.normal.reshape(*batch_shape, 3),
        )
