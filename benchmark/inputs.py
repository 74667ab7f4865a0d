"""The benchmark's own inputs, made from ``--seed`` on the device.

Spheres and rays are drawn with a ``torch.Generator`` on the run's device,
one stream per kind of input (:func:`stream_seed`), in a few large calls:
the same seed gives the same inputs on the same device. The program and the
plain reference are handed the same tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_MIX = 0x9E3779B97F4A7C15
_STREAM = 0xBF58476D1CE4E5B9


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for input stream ``stream`` of run seed ``seed``
    (any Python int, negative or beyond 64 bits included)."""
    x = (seed * _MIX + (stream + 1) * _STREAM) % (1 << 64)
    x ^= x >> 31
    return (x * 0x94D049BB133111EB % (1 << 64)) >> 1


def generator(seed: int, stream: int, device: torch.device):
    return torch.Generator(device=device).manual_seed(stream_seed(seed,
                                                                  stream))


def spheres(cfg: dict, seed: int, device: torch.device):
    """(centres (N, 3), radii (N,), albedo (N, 3)) f32: centres uniform in
    the centred cube of side ``world``, one radius, albedo uniform in
    [0, 1] (src/benchmark.c:306-314, src/sphere.c:34-41)."""
    g = generator(seed, 0, device)
    n, world = int(cfg["spheres"]), float(cfg["world"])
    centers = torch.rand((n, 3), generator=g, device=device) * world \
        - world / 2
    radii = torch.full((n,), float(cfg["radius"]), device=device)
    albedo = torch.rand((n, 3), generator=g, device=device)
    return centers, radii, albedo


def directions(n: int, seed: int, stream: int, device: torch.device):
    """(n, 3) unit directions, uniform in [-1, 1]^3 then normalised, as the
    reference's benchmark rays (src/benchmark.c:183-190)."""
    g = generator(seed, stream, device)
    d = torch.rand((n, 3), generator=g, device=device) * 2 - 1
    return d / torch.linalg.vector_norm(d, dim=1, keepdim=True)


def numpy_rng(seed: int, stream: int):
    """A NumPy generator for host-side draws (samples, reservoirs)."""
    return np.random.default_rng(stream_seed(seed, stream))


def fly_positions(camera: dict, speed: float, frames: int) -> np.ndarray:
    """(frames, 3) f32 camera positions: frame k stands k * speed units
    along the camera's forward axis from its start (the scripted WASD of
    src/main.c:288-315)."""
    y, p = float(camera["yaw"]), float(camera["pitch"])
    f = np.array([math.cos(p) * math.sin(y), math.sin(p),
                  math.cos(p) * math.cos(y)])
    f /= np.linalg.norm(f)
    k = np.arange(frames, dtype=np.float64)[:, None]
    return (np.asarray(camera["position"], np.float64) + k * speed * f) \
        .astype(np.float32)
