"""Ray/tile data parallelism on ``torch.distributed`` (the DP strategy).

PyTorch counterpart of ``tracer/dist/shard.py``. The wavefront shards across
the mesh's ``rays`` axis; the scene (and any tables the intersector holds)
is replicated. Each rank traces its block of rays on its own, with no
communication, and one all-gather over the ray group puts the results back
in ray order on every rank.

Sharded rendering is bitwise equal to the unsharded render: the bounce
noise is drawn once for the whole frame from the caller's generator
(``integrator.bounce_noise``) and sliced with the rows.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import Tensor
from torch.distributed.device_mesh import DeviceMesh

from tracer_torch.config import DEFAULT_CONFIG, TracerConfig
from tracer_torch.core.types import HitRecord, Ray
from tracer_torch.dist.mesh import (RAY_AXIS, all_gather_cat, axis_group,
                                    shard_rows)
from tracer_torch.integrator.wavefront import bounce_noise, trace_radiance
from tracer_torch.scene.camera import Camera, camera_rays
from tracer_torch.scene.scene import Scene


def gather_rows(out, group):
    """A rank's result gathered along its leading (ray) dimension: a
    tensor, a HitRecord, or a tuple or list of tensors."""
    if isinstance(out, Tensor):
        return all_gather_cat(out, group)
    if isinstance(out, HitRecord):
        return HitRecord(t=all_gather_cat(out.t, group),
                         index=all_gather_cat(out.index, group),
                         hit=all_gather_cat(out.hit, group),
                         point=all_gather_cat(out.point, group),
                         normal=all_gather_cat(out.normal, group))
    if isinstance(out, (tuple, list)):
        return type(out)(gather_rows(x, group) for x in out)
    raise TypeError(f"cannot gather a {type(out).__name__}")


def nearest_hit_sharded(rays: Ray, scene: Scene, mesh: DeviceMesh,
                        nearest_hit: Callable):
    """Closest hit with rays sharded over the mesh's ray axis; the scene
    replicated. The rays' leading batch dimension must divide by the axis
    size. ``nearest_hit(rays, scene)`` returns a HitRecord (or tensors whose
    leading dimension is the batch's); every rank gets the whole batch's."""
    group, rank, n = axis_group(mesh, RAY_AXIS)
    local = Ray(origin=shard_rows(rays.origin, rank, n),
                direction=shard_rows(rays.direction, rank, n))
    return gather_rows(nearest_hit(local, scene), group)


def render_sharded(scene: Scene, camera: Camera,
                   generator: torch.Generator | None, mesh: DeviceMesh,
                   nearest_hit: Callable[[Ray, Scene], HitRecord],
                   config: TracerConfig = DEFAULT_CONFIG) -> Tensor:
    """One path-traced frame with pixel rows sharded over the ray axis:
    (H, W, 3) clamped to [0, 1] on every rank.

    H must divide by the ray-axis size. The bounce noise is drawn once for
    the whole frame from ``generator`` (every rank's in the same state), so
    the image is bitwise the unsharded ``render`` with that noise.
    """
    group, rank, n = axis_group(mesh, RAY_AXIS)
    h = config.height
    if h % n:
        raise ValueError(f"height {h} must divide ray shards {n}")
    rays = camera_rays(camera, config)                     # (H, W, 3)
    noise = bounce_noise(generator, (h, config.width), config.max_depth,
                         device=rays.origin.device)
    rows = slice(rank * (h // n), (rank + 1) * (h // n))
    local = Ray(origin=rays.origin[rows], direction=rays.direction[rows])
    img = trace_radiance(lambda r: nearest_hit(r, scene), scene, local,
                         max_depth=config.max_depth, noise=noise[:, rows])
    return all_gather_cat(torch.clamp(img, 0.0, 1.0), group)
