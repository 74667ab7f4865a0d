"""Branch-free hemisphere sampling.

PyTorch counterpart of ``tracer/core/sampling.py``. The reference samples
bounce directions with a rejection loop (``random_in_unit_sphere``,
src/sphere.c:19-24) and flips them into the normal's hemisphere
(``random_on_hemisphere``, src/sphere.c:26-32). Here a 3-D standard normal
is normalised, which gives the same uniform-on-sphere distribution in fixed
time, followed by the same sign flip.

The samplers draw from an explicit ``torch.Generator``; its stream differs
from ``jax.random``'s, so tests hand both packages the same numpy noise
through :func:`hemisphere_from_noise`.
"""

from __future__ import annotations

import torch
from torch import Tensor

from tracer_torch import trace
from tracer_torch.core import vecmath


def _guard_zero(v: Tensor) -> Tensor:
    """Replace the measure-zero all-zeros draw by +x, as the reference
    guards ``vec3_dot(p,p) != 0``."""
    deg = vecmath.dot(v, v)[..., None] == 0.0
    with trace.span("sync", "axis"):
        x = torch.tensor([1.0, 0.0, 0.0], dtype=v.dtype, device=v.device)
    return torch.where(deg, x, v)


def _flip_to(s: Tensor, normal: Tensor) -> Tensor:
    """Keep s where s.n > 0, else -s: a sample exactly perpendicular to the
    normal (dot == 0) is negated, as in src/sphere.c:26-32."""
    keep = vecmath.dot(s, normal) > 0.0
    return torch.where(keep[..., None], s, -s)


def uniform_on_sphere(generator: torch.Generator, batch_shape=(),
                      device=None) -> Tensor:
    """Uniform direction on the unit sphere, shape ``(*batch_shape, 3)``,
    drawn on the generator's device and moved to ``device``."""
    v = torch.randn((*batch_shape, 3), generator=generator,
                    dtype=torch.float32, device=generator.device)
    v = v.to(device if device is not None else generator.device)
    return vecmath.normalize(_guard_zero(v))


def uniform_on_hemisphere(generator: torch.Generator,
                          normal: Tensor) -> Tensor:
    """Uniform direction on the hemisphere around ``normal (..., 3)``."""
    s = uniform_on_sphere(generator, normal.shape[:-1], device=normal.device)
    return _flip_to(s, normal)


def hemisphere_from_noise(noise: Tensor, normal: Tensor) -> Tensor:
    """Hemisphere sample from pre-drawn Gaussian ``noise (..., 3)``."""
    return _flip_to(vecmath.normalize(_guard_zero(noise)), normal)
