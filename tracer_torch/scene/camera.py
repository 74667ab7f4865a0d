"""Pinhole fly-camera and primary-ray generation.

PyTorch counterpart of ``tracer/scene/camera.py``. The camera is a small
dataclass of tensors ``{position, yaw, pitch, fov}``; its basis is derived
inside ray generation, so autograd reaches the pose. The whole W x H
wavefront comes out of one broadcast (the reference's per-pixel loop,
src/main.c:358-374).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch
from torch import Tensor

from tracer_torch import trace
from tracer_torch.config import DEFAULT_CONFIG, TracerConfig
from tracer_torch.core import vecmath
from tracer_torch.core.device import default_device
from tracer_torch.core.types import Ray

_WORLD_UP = (0.0, 1.0, 0.0)


@dataclass
class Camera:
    """Fly-camera pose: position (3,) f32, yaw and pitch () f32 radians,
    fov () f32 degrees."""

    position: Tensor
    yaw: Tensor
    pitch: Tensor
    fov: Tensor

    @classmethod
    def default(cls, device=None) -> "Camera":
        """The reference's interactive-mode camera (src/main.c:203-211):
        position (0,4,50), yaw -pi, pitch 0, fov 45 degrees (looks down -z).
        On the CUDA device unless ``device`` names another."""
        device = default_device(device)

        def f32(x):
            return torch.tensor(x, dtype=torch.float32, device=device)

        return cls(position=f32([0.0, 4.0, 50.0]), yaw=f32(-math.pi),
                   pitch=f32(0.0), fov=f32(45.0))

    def replace(self, **changes) -> "Camera":
        return replace(self, **changes)

    def basis(self):
        """(forward, right, up) from yaw/pitch, as ``camera_update``
        (src/camera.c:10-18): right = normalize(forward x (0,1,0))."""
        forward = torch.stack([
            torch.cos(self.pitch) * torch.sin(self.yaw),
            torch.sin(self.pitch),
            torch.cos(self.pitch) * torch.cos(self.yaw),
        ]).to(torch.float32)
        forward = vecmath.normalize(forward)
        with trace.span("sync", "world_up"):
            world_up = torch.tensor(_WORLD_UP, dtype=torch.float32,
                                    device=forward.device)
        right = vecmath.normalize(vecmath.cross(forward, world_up))
        up = vecmath.normalize(vecmath.cross(right, forward))
        return forward, right, up


def pixel_uv(config: TracerConfig = DEFAULT_CONFIG, device=None):
    """(u, v) screen coordinates of every pixel, each (H, W), as the pixel
    loop maps them (src/main.c:362-365): u = (x/W - 0.5) * aspect (dropped
    with ``double_aspect_compat=False``), v = -(y/H - 0.5)."""
    device = default_device(device)
    x = torch.arange(config.width, dtype=torch.float32, device=device)
    y = torch.arange(config.height, dtype=torch.float32, device=device)
    u = x / config.width - 0.5
    if config.double_aspect_compat:
        u = u * config.aspect_ratio
    v = -(y / config.height - 0.5)
    vv, uu = torch.meshgrid(v, u, indexing="ij")          # (H, W) each
    return uu, vv


def camera_rays(camera: Camera, config: TracerConfig = DEFAULT_CONFIG,
                uv=None) -> Ray:
    """All primary rays of the frame, batch shape (H, W), as
    ``get_camera_ray`` (src/ray.c:17-32): direction = normalize(forward +
    right * 2*half_width*u + up * 2*half_height*v), half_height =
    tan(fov/2), half_width = aspect * half_height."""
    forward, right, up = camera.basis()
    fov_rad = camera.fov * (math.pi / 180.0)
    half_height = torch.tan(fov_rad / 2.0)
    half_width = config.aspect_ratio * half_height
    u, v = pixel_uv(config, camera.position.device) if uv is None else uv
    direction = (forward
                 + (2.0 * half_width) * u[..., None] * right
                 + (2.0 * half_height) * v[..., None] * up)
    direction = vecmath.normalize(direction)
    origin = torch.broadcast_to(camera.position, direction.shape)
    return Ray(origin=origin, direction=direction)
