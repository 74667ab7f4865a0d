"""Wavefront path-tracing and direct-lighting integrators.

PyTorch counterpart of ``tracer/integrator/wavefront.py``. The reference's
recursive integrator (``trace_ray``, src/renderer.c:21-77) unrolls into
``L = sum_k 0.5^k * albedo_k`` plus ``0.5^m * sky`` if the path escapes at
bounce m: every bounce is one batched nearest-hit over the whole wavefront
and one batched shading and sampling step, with masks carrying liveness.
Color is float32, clamped to [0, 1] at the end (the reference's Uint8
wrap-around is not copied).

Bounce directions come from pre-drawn Gaussian ``noise`` (one
(depth - 1, H, W, 3) tensor per frame, :func:`bounce_noise`) or from a
``torch.Generator``; tests hand the JAX package and the port the same
numpy noise, since the two random streams differ.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
from torch import Tensor

from tracer_torch import trace
from tracer_torch.config import DEFAULT_CONFIG, TracerConfig
from tracer_torch.core import sampling
from tracer_torch.core.sort import direction_morton_codes
from tracer_torch.core.types import HitRecord, Ray
from tracer_torch.scene.camera import Camera, camera_rays
from tracer_torch.scene.scene import Scene

# Reference sky gradient endpoints (src/renderer.c:65-70), in [0,1] scale.
_SKY_HORIZON = (1.0, 1.0, 1.0)
_SKY_ZENITH = (128.0 / 255.0, 178.0 / 255.0, 1.0)
_PARK = 1.0e18   # origin of parked (dead) rays, far outside every scene

NearestHitFn = Callable[[Ray], HitRecord]
OccludedFn = Callable[[Ray, Tensor], Tensor]


def sky_color(direction: Tensor) -> Tensor:
    """Sky gradient keyed to direction.y (src/renderer.c:65-70):
    t = 0.5 * (dir.y + 1); white at the horizon, light blue at the zenith."""
    t = 0.5 * (direction[..., 1] + 1.0)
    # Copies from pageable host memory: each waits for the device.
    with trace.span("sync", "sky"):
        a = torch.tensor(_SKY_HORIZON, dtype=torch.float32,
                         device=direction.device)
        b = torch.tensor(_SKY_ZENITH, dtype=torch.float32,
                         device=direction.device)
    return (1.0 - t[..., None]) * a + t[..., None] * b


def bounce_noise(generator: torch.Generator, batch_shape, max_depth: int,
                 device=None) -> Tensor:
    """Pre-drawn Gaussian bounce noise, (max_depth - 1, *batch_shape, 3)
    f32, drawn on the generator's device and moved to ``device``."""
    device = device if device is not None else generator.device
    if max_depth <= 1:
        return torch.zeros((0, *batch_shape, 3), dtype=torch.float32,
                           device=device)
    n = torch.randn((max_depth - 1, *batch_shape, 3), generator=generator,
                    dtype=torch.float32, device=generator.device)
    return n.to(device)


@trace.spanned("compaction")
def _compact_rays(rays: Ray, active: Tensor):
    """Wavefront compaction for one bounce: the flat wavefront sorted so
    live rays cluster by direction (cube-Morton code) and dead rays pack
    into the tail, where they are parked (origin 1e18, direction +x) so the
    culls give their subpackets nothing to test. The sort is stable, as
    ``jnp.argsort``. Returns (rays', inverse permutation)."""
    o = rays.origin.reshape(-1, 3)
    d = rays.direction.reshape(-1, 3)
    a = active.reshape(-1)
    code = direction_morton_codes(d)
    key = torch.where(a, code, code | (1 << 25))   # dead bit above 24 bits
    perm = torch.argsort(key, stable=True)
    inv = torch.argsort(perm, stable=True)
    ap = a[perm][:, None]
    park_o = torch.full((1, 3), _PARK, dtype=torch.float32, device=o.device)
    with trace.span("sync", "park"):
        park_d = torch.tensor([[1.0, 0.0, 0.0]], dtype=torch.float32,
                              device=o.device)
    return Ray(origin=torch.where(ap, o[perm], park_o),
               direction=torch.where(ap, d[perm], park_d)), inv


def _unpermute(rec: HitRecord, inv: Tensor, batch_shape) -> HitRecord:
    flat = rec.reshape((-1,))
    return HitRecord(t=flat.t[inv], index=flat.index[inv], hit=flat.hit[inv],
                     point=flat.point[inv],
                     normal=flat.normal[inv]).reshape(batch_shape)


def trace_radiance(nearest_hit: NearestHitFn, scene: Scene, rays: Ray,
                   generator: torch.Generator | None = None,
                   max_depth: int = 5, noise: Tensor | None = None,
                   compact: bool = False) -> Tensor:
    """Radiance for a wavefront of rays; batch shape (...,) -> (..., 3).

    Bounce directions come from ``noise`` when given, else from
    ``generator``. ``compact=True`` re-sorts the wavefront before every
    bounce after the first (:func:`_compact_rays`); results are the same.
    Each bounce is the span ``tracer_torch.bounce``, its argument the
    bounce's index; where the trace is on it counts ``live_rays``, the
    live paths entering the bounce (one reduction), and ``slots``, the
    wavefront's.
    """
    batch_shape = rays.batch_shape
    dev = rays.origin.device
    radiance = torch.zeros((*batch_shape, 3), dtype=torch.float32,
                           device=dev)
    throughput = torch.ones(batch_shape, dtype=torch.float32, device=dev)
    active = torch.ones(batch_shape, dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    for bounce in range(max_depth):
        with trace.span("bounce", bounce):
            if trace.on():
                with trace.counting():
                    trace.count(live_rays=active.sum(), slots=active.numel())
            if compact and bounce > 0:
                crays, inv = _compact_rays(rays, active)
                rec = _unpermute(nearest_hit(crays), inv, batch_shape)
                rec.hit = rec.hit & active
                rec.index = torch.where(active, rec.index,
                                        torch.full_like(rec.index, -1))
            else:
                rec = nearest_hit(rays)
            hit_now = active & rec.hit
            miss_now = active & ~rec.hit

            albedo = scene.albedo[torch.clamp(rec.index, min=0).long()]
            radiance = radiance + torch.where(
                hit_now[..., None], throughput[..., None] * albedo, zero)
            radiance = radiance + torch.where(
                miss_now[..., None],
                throughput[..., None] * sky_color(rays.direction), zero)

            active = hit_now
            throughput = throughput * 0.5

            if bounce + 1 < max_depth:
                if noise is not None:
                    new_dir = sampling.hemisphere_from_noise(noise[bounce],
                                                             rec.normal)
                else:
                    new_dir = sampling.uniform_on_hemisphere(generator,
                                                             rec.normal)
                # The bounce ray starts exactly at the hit point
                # (renderer.c:54); t > EPSILON stands in for a self-hit
                # offset.
                rays = Ray(origin=rec.point, direction=new_dir)
    # Paths alive after max_depth bounces add black (renderer.c:23-24).
    return radiance


@trace.spanned("render")
def render(scene: Scene, camera: Camera,
           generator: torch.Generator | None,
           nearest_hit_for: Callable[[Scene], NearestHitFn],
           config: TracerConfig = DEFAULT_CONFIG, noise: Tensor | None = None,
           compact: bool = False) -> Tensor:
    """One frame: (H, W, 3) float32 radiance clamped to [0, 1]."""
    rays = camera_rays(camera, config)
    img = trace_radiance(nearest_hit_for(scene), scene, rays, generator,
                         config.max_depth, noise=noise, compact=compact)
    return torch.clamp(img, 0.0, 1.0)


def trace_direct(nearest_hit: NearestHitFn, occluded: OccludedFn,
                 scene: Scene, rays: Ray, light_pos: Tensor,
                 light_intensity: float = 1.0, ambient: float = 0.1,
                 compact: bool = False) -> Tensor:
    """Primary plus shadow rays (BASELINE config 3); (...,) -> (..., 3).

    One closest hit for the primary rays, one any-hit query along the
    segments hit point -> point light, then a Lambertian term
    ``albedo * (ambient + intensity * visible * max(0, n.l))`` on hits and
    the sky on misses. Shadow rays take the UNNORMALISED direction
    (light - point) with t_max = 1, so one any-hit covers exactly the
    segment; a miss pixel's point is its own origin. ``compact=True``
    parks the shadow rays of miss pixels (:func:`_compact_rays`).
    The shadow query (compaction, the occlusion call, the un-permute) is
    the span ``tracer_torch.shadow``; where the trace is on it counts
    ``live_rays``, the hit pixels whose shadow rays matter (one
    reduction), and ``slots``, the query's rays.
    """
    batch_shape = rays.batch_shape
    rec = nearest_hit(rays)

    to_light = light_pos - rec.point
    tmax = torch.ones(batch_shape, dtype=torch.float32,
                      device=rays.origin.device)
    srays = Ray(origin=rec.point, direction=to_light)
    with trace.span("shadow"):
        if trace.on():
            with trace.counting():
                trace.count(live_rays=rec.hit.sum(), slots=rec.hit.numel())
        if compact:
            crays, inv = _compact_rays(srays, rec.hit)
            occ = occluded(crays, tmax.reshape(-1))
            occ = occ.reshape(-1)[inv].reshape(batch_shape)
        else:
            occ = occluded(srays, tmax)

    dist = torch.linalg.vector_norm(to_light, dim=-1, keepdim=True)
    l = to_light / torch.clamp(dist, min=1e-12)
    ndotl = torch.clamp(torch.sum(rec.normal * l, dim=-1), min=0.0)
    vis = torch.where(rec.hit & ~occ, ndotl, torch.zeros_like(ndotl))

    albedo = scene.albedo[torch.clamp(rec.index, min=0).long()]
    lit = albedo * (ambient + light_intensity * vis)[..., None]
    return torch.where(rec.hit[..., None], lit, sky_color(rays.direction))


@trace.spanned("render")
def render_direct(scene: Scene, camera: Camera, light_pos,
                  nearest_hit_for: Callable[[Scene], NearestHitFn],
                  occluded_for: Callable[[Scene], OccludedFn],
                  config: TracerConfig = DEFAULT_CONFIG,
                  light_intensity: float = 1.0, ambient: float = 0.1,
                  compact: bool = False) -> Tensor:
    """One direct-lit frame: (H, W, 3) float32 clamped to [0, 1]."""
    rays = camera_rays(camera, config)
    light = torch.as_tensor(light_pos, dtype=torch.float32,
                            device=rays.origin.device)
    img = trace_direct(nearest_hit_for(scene), occluded_for(scene), scene,
                       rays, light, light_intensity=light_intensity,
                       ambient=ambient, compact=compact)
    return torch.clamp(img, 0.0, 1.0)


@dataclass
class Accumulator:
    """Temporal accumulation: running sum and frame count. The reference's
    accumulated_colors buffer and its reset-on-move / average-while-still
    logic (src/main.c:241-273, 376-408); ``mean`` is the display image."""

    total: Tensor   # (H, W, 3) f32
    frames: int

    @classmethod
    def zero(cls, height: int, width: int, device=None) -> "Accumulator":
        return cls(total=torch.zeros((height, width, 3), dtype=torch.float32,
                                     device=device), frames=0)

    def add(self, frame: Tensor) -> "Accumulator":
        return Accumulator(total=self.total + frame, frames=self.frames + 1)

    def reset_to(self, frame: Tensor) -> "Accumulator":
        """Camera moved: restart from this frame (main.c:376-380)."""
        return Accumulator(total=frame, frames=1)

    @property
    def mean(self) -> Tensor:
        return torch.clamp(self.total / float(max(self.frames, 1)), 0.0, 1.0)
