"""Struct-of-arrays scene and its factories.

PyTorch counterpart of ``tracer/scene/scene.py``. The reference's sphere
array-of-structs (include/Custom/sphere.h:7-11) becomes three dense tensors:
``centers (N,3)``, ``radii (N,)``, ``albedo (N,3)`` in [0, 1].

The factories take an explicit ``torch.Generator``. They draw from the same
distributions as the JAX factories but cannot reproduce ``jax.random``'s
stream: tests that compare the two packages build one scene as numpy arrays
and hand it to both (``tracer_torch.interop.scene_from_numpy``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import Tensor


@dataclass
class Scene:
    """SoA sphere scene.

    centers: (N, 3) float32
    radii:   (N,)   float32
    albedo:  (N, 3) float32 in [0, 1]
    """

    centers: Tensor
    radii: Tensor
    albedo: Tensor

    @property
    def num_spheres(self) -> int:
        return self.centers.shape[0]


def fixed_scene(centers, radii, albedo=None, device=None) -> Scene:
    """Scene from explicit arrays; reference ``create_sphere``
    (src/sphere.c:43-50), which zero-initializes color."""
    centers = torch.as_tensor(centers, dtype=torch.float32,
                              device=device).reshape(-1, 3)
    radii = torch.as_tensor(radii, dtype=torch.float32,
                            device=device).reshape(-1)
    if albedo is None:
        albedo = torch.zeros_like(centers)
    else:
        albedo = torch.as_tensor(albedo, dtype=torch.float32,
                                 device=device).reshape(-1, 3)
    return Scene(centers=centers, radii=radii, albedo=albedo)


def _uniform(generator: torch.Generator, shape, lo, hi) -> Tensor:
    return torch.rand(shape, generator=generator, dtype=torch.float32) \
        * (hi - lo) + lo


def random_scene(generator: torch.Generator, n: int = 20,
                 device=None) -> Scene:
    """The interactive-mode scene (src/sphere.c:52-59, src/main.c:18,218-221):
    center x in [-40,40], y in [-20,20], z in [-10,5]; radius in [0.5,5];
    albedo uniform. Drawn on the CPU from ``generator``, then moved."""
    lo = torch.tensor([-40.0, -20.0, -10.0])
    hi = torch.tensor([40.0, 20.0, 5.0])
    centers = _uniform(generator, (n, 3), lo, hi)
    radii = _uniform(generator, (n,), 0.5, 5.0)
    albedo = _uniform(generator, (n, 3), 0.0, 1.0)
    return Scene(centers=centers.to(device), radii=radii.to(device),
                 albedo=albedo.to(device))


def benchmark_scene(generator: torch.Generator, n: int,
                    world_size: float = 1000.0, radius: float = 0.5,
                    device=None) -> Scene:
    """The benchmark sweep's scene: n spheres of fixed radius uniform in a
    centered cube of side ``world_size`` (src/benchmark.c:306-314,
    src/sphere.c:34-41). Drawn on the CPU from ``generator``, then moved."""
    half = world_size / 2.0
    centers = _uniform(generator, (n, 3), -half, half)
    radii = torch.full((n,), radius, dtype=torch.float32)
    albedo = _uniform(generator, (n, 3), 0.0, 1.0)
    return Scene(centers=centers.to(device), radii=radii.to(device),
                 albedo=albedo.to(device))
