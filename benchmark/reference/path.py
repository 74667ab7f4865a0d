"""The path-traced pixel: camera ray, bounces and shading.

Primary rays as the pixel loop and ``get_camera_ray`` make them
(src/main.c:358-374, src/ray.c:17-32, with the aspect ratio applied twice
as the reference does); each bounce takes the brute-force closest hit; a
hit adds throughput x albedo and bounces from the hit point along the
Gaussian noise flipped into the normal's hemisphere (src/sphere.c:19-32);
a miss adds throughput x sky (src/renderer.c:65-70); throughput halves at
every bounce and paths still alive after the last add nothing
(src/renderer.c:21-77). The colour is clamped to [0, 1].
"""

from __future__ import annotations

import math

import torch
from torch import Tensor

from benchmark.reference.sphere import closest_hit, dot, normalize

SKY_HORIZON = (1.0, 1.0, 1.0)
SKY_ZENITH = (128.0 / 255.0, 178.0 / 255.0, 1.0)


def sky(d: Tensor) -> Tensor:
    t = 0.5 * (d[..., 1] + 1.0)
    a = torch.tensor(SKY_HORIZON, dtype=d.dtype, device=d.device)
    b = torch.tensor(SKY_ZENITH, dtype=d.dtype, device=d.device)
    return (1.0 - t[..., None]) * a + t[..., None] * b


def camera_rays(position: Tensor, yaw: float, pitch: float, fov: float,
                width: int, height: int, pixels: Tensor, dtype):
    """(o, d) (n, 3) of the flat pixel indices ``pixels`` (y * width + x)."""
    dev = position.device

    def s(x):
        return torch.tensor(x, dtype=dtype, device=dev)

    yaw_t, pitch_t = s(yaw), s(pitch)
    forward = normalize(torch.stack([
        torch.cos(pitch_t) * torch.sin(yaw_t), torch.sin(pitch_t),
        torch.cos(pitch_t) * torch.cos(yaw_t)]))
    world_up = torch.tensor([0.0, 1.0, 0.0], dtype=dtype, device=dev)
    right = normalize(torch.linalg.cross(forward, world_up, dim=-1))
    up = normalize(torch.linalg.cross(right, forward, dim=-1))
    half_h = torch.tan(s(fov) * (math.pi / 180.0) / 2.0)
    aspect = float(width) / float(height)
    half_w = aspect * half_h
    x = (pixels % width).to(dtype)
    y = (pixels // width).to(dtype)
    u = (x / width - 0.5) * aspect
    v = -(y / height - 0.5)
    d = normalize(forward + (2.0 * half_w) * u[:, None] * right
                  + (2.0 * half_h) * v[:, None] * up)
    o = torch.broadcast_to(position.to(dtype), d.shape)
    return o, d


def hemisphere(noise: Tensor, normal: Tensor) -> Tensor:
    """The noise normalised (the all-zero draw as +x) and flipped into the
    normal's hemisphere; a sample on its plane is flipped."""
    deg = dot(noise, noise)[..., None] == 0.0
    x = torch.tensor([1.0, 0.0, 0.0], dtype=noise.dtype, device=noise.device)
    s = normalize(torch.where(deg, x, noise))
    return torch.where((dot(s, normal) > 0.0)[..., None], s, -s)


def radiance(o: Tensor, d: Tensor, noise: Tensor, centers: Tensor,
             radii: Tensor, albedo: Tensor, depth: int,
             dtype=torch.float32) -> Tensor:
    """(n, 3) f32 colour of n paths; noise (depth - 1, n, 3)."""
    c = centers.to(dtype)
    alb = albedo.to(dtype)
    n = o.shape[0]
    rad = torch.zeros((n, 3), dtype=dtype, device=o.device)
    thr = torch.ones(n, dtype=dtype, device=o.device)
    live = torch.arange(n, device=o.device)
    o, d = o.to(dtype), d.to(dtype)
    for bounce in range(depth):
        t, idx = closest_hit(o, d, c, radii, dtype=dtype)
        hit = idx >= 0
        miss = live[~hit]
        rad[miss] += thr[~hit, None] * sky(d[~hit])
        live, o, d, t, idx, thr = (live[hit], o[hit], d[hit], t[hit],
                                   idx[hit], thr[hit])
        rad[live] += thr[:, None] * alb[idx]
        thr = thr * 0.5
        if bounce + 1 == depth or live.numel() == 0:
            break
        p = o + t.to(dtype)[:, None] * d
        normal = normalize(p - c[idx])
        o, d = p, hemisphere(noise[bounce, live].to(dtype), normal)
    return torch.clamp(rad.float(), 0.0, 1.0)
