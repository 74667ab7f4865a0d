"""Inverse rendering: fit scene geometry, material and camera to a target
image (BASELINE config 4).

PyTorch counterpart of ``tracer/diff/fit.py``. Gradient descent on the
smoothed forward model (:mod:`tracer_torch.diff.soft`): pixels -> MSE loss
-> autograd -> Adam updates of sphere centres, radii and albedo, and with
``optimize_camera`` of the camera's position, yaw and pitch. Radii are
parameterised through softplus to stay positive, albedo through a sigmoid
to stay in [0, 1].

The optimiser is ``torch.optim.Adam`` (betas 0.9 / 0.999, eps 1e-8), the
update of ``optax.adam``. The pose is in it whether or not it is fitted,
so the optimiser state has the JAX state's leaves, and a checkpoint
(:mod:`tracer_torch.checkpoint`) holds, in flatten order: the six
parameters (albedo_raw, centers, radii_raw, pitch, position, yaw), Adam's
step count (int32), then its first and second moments in parameter order;
19 leaves, the layout of a checkpoint the JAX fit writes, which this fit
resumes from. Without ``optimize_camera`` the rays are generated once and
the pose's gradients are zero, so the camera comes back as it was passed.

Deviations from the JAX fit, both repairs of its faults:

  * ``optimize_camera=True`` fits the pose. The JAX fit generates the rays
    once from the initial camera, so its loss never reaches the pose and
    the pose never moves. Here the loss makes the rays from the pose
    parameters on every step (:func:`make_loss_fn`), at pixel coordinates
    computed once.
  * On a mesh the gradient is the gradient of the mean loss over all rays,
    equal to the unsharded fit's. The JAX fit's is R times that for R ray
    shards: shard_map adds a psum over the ray axis where the replicated
    parameters meet the ray-sharded loss, and its explicit psum of g / R
    then averages R equal values.

On a mesh (``mesh=``, a :mod:`tracer_torch.dist` mesh) every rank takes its
block of the rays and the parameters stay replicated: the loss and the
gradients are all-reduced over the ray group, the data-parallel gradient
all-reduce, each rank's part scaled by 1 / (R * T). With
``grad_microbatch`` T > 1 the block is cut into T tiles, and each tile's
gradients go out in an asynchronous all-reduce as soon as its backward
ends, while the next tile computes; every handle is waited on before the
Adam step.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor

from tracer_torch.bench.timing import Clock
from tracer_torch.checkpoint import (load_state, save_state, tree_leaves,
                                     tree_unflatten)
from tracer_torch.config import DEFAULT_CONFIG, TracerConfig
from tracer_torch.core.types import Ray
from tracer_torch.diff.soft import SoftParams, clip, maximum, soft_render
from tracer_torch.scene.camera import Camera, camera_rays, pixel_uv
from tracer_torch.scene.scene import Scene

BETAS = (0.9, 0.999)
EPS = 1e-8


class FitResult(NamedTuple):
    scene: Scene
    camera: Camera
    losses: np.ndarray
    step_ms: np.ndarray     # wall time of each step run (not of resumed ones)


def scene_to_params(scene: Scene) -> dict:
    """Unconstrained parameters: radii > 0 through softplus^-1, albedo in
    [0, 1] through its logit."""
    p = clip(scene.albedo, 1e-5, 1 - 1e-5)
    return {
        "centers": scene.centers,
        "radii_raw": torch.log(torch.expm1(maximum(scene.radii, 1e-6))),
        "albedo_raw": torch.log(p / (1 - p)),
    }


def params_to_scene(params: dict) -> Scene:
    raw = params["radii_raw"]
    return Scene(centers=params["centers"],
                 radii=torch.logaddexp(raw, torch.zeros_like(raw)),
                 albedo=torch.sigmoid(params["albedo_raw"]))


def make_loss_fn(camera: Camera, soft: SoftParams, config: TracerConfig,
                 optimize_camera: bool):
    """loss_fn((scene_params, cam_params), ray_o, ray_d, target, uv=None)
    -> the mean squared error of the soft image of the rays against target.

    Without ``optimize_camera`` the rays are (ray_o, ray_d). With it they
    are made from the pose parameters on every call, at the pixels' screen
    coordinates ``uv`` = (u, v) (:func:`tracer_torch.scene.camera.pixel_uv`,
    cut as the target is), so that autograd reaches the pose; ray_o and
    ray_d are then not read."""
    def loss_fn(all_params, ray_o, ray_d, target, uv=None):
        scene_params, cam_params = all_params
        if optimize_camera:
            rays = camera_rays(camera.replace(**cam_params), config, uv=uv)
        else:
            rays = Ray(origin=ray_o, direction=ray_d)
        img = soft_render(params_to_scene(scene_params), None, soft, config,
                          rays=rays)
        return torch.mean((img - target) ** 2)
    return loss_fn


def view_error(camera: Camera, reference: Camera, depth: float) -> float:
    """A camera pose's distance from a reference pose as one angle: the
    norm of the yaw and pitch errors plus the position error over
    ``depth``, the distance of the scene. A sideways shift of the camera by
    x moves the view of a scene at that depth as a turn by x / depth does,
    and the fit can trade one for the other (a shift of the pose is also
    nearly a shift of every centre, which the fit moves too)."""
    turn = torch.hypot(camera.yaw - reference.yaw,
                       camera.pitch - reference.pitch)
    shift = torch.linalg.vector_norm(camera.position - reference.position)
    return float(turn + shift / depth)


def adam_state_dict(count: int, mu, nu, lr: float) -> dict:
    """A ``torch.optim.Adam`` state dict for parameters 0..len(mu)-1 after
    ``count`` steps with first moments ``mu`` and second moments ``nu``."""
    state = {} if count == 0 else {
        i: {"step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": m, "exp_avg_sq": v}
        for i, (m, v) in enumerate(zip(mu, nu))}
    # The group's fields as this torch version's Adam spells them.
    groups = torch.optim.Adam([torch.zeros(1)], lr=lr, betas=BETAS,
                              eps=EPS).state_dict()["param_groups"]
    groups[0]["params"] = list(range(len(mu)))
    return {"state": state, "param_groups": groups}


def _state_tree(all_params, opt: torch.optim.Adam):
    """(params, ((count, mu, nu), ())): the JAX fit's checkpoint tree."""
    params = tree_leaves(all_params)
    st = [opt.state.get(p, {}) for p in params]
    count = int(st[0]["step"]) if st[0] else 0
    mu = [s["exp_avg"] if s else torch.zeros_like(p)
          for s, p in zip(st, params)]
    nu = [s["exp_avg_sq"] if s else torch.zeros_like(p)
          for s, p in zip(st, params)]
    return (all_params, ((torch.tensor(count, dtype=torch.int32),
                          tree_unflatten(all_params, mu),
                          tree_unflatten(all_params, nu)), ()))


def fit_scene(target: Tensor, init_scene: Scene, camera: Camera,
              steps: int = 200, lr: float = 3e-2,
              soft: SoftParams | None = None,
              config: TracerConfig = DEFAULT_CONFIG,
              optimize_camera: bool = False,
              mesh=None,
              grad_microbatch: int = 1,
              checkpoint_path: str | None = None,
              checkpoint_every: int = 50,
              resume: bool = False) -> FitResult:
    """Fit the scene (and with ``optimize_camera`` the camera pose) to
    ``target`` (H, W, 3) on the device the inputs live on.

    With ``checkpoint_path`` the whole optimisation state (parameters, Adam
    moments, step count, loss history) is saved every ``checkpoint_every``
    steps and at the end (:func:`tracer_torch.checkpoint.save_state`); with
    ``resume=True`` a killed run continues from the last checkpoint, and
    the remaining steps are bitwise those of an uninterrupted run.

    With ``mesh`` every rank of it calls the fit with the same arguments;
    the rays shard over its ray axis (their count must divide by the axis
    size times ``grad_microbatch``), every rank returns the same result,
    and only global rank 0 writes checkpoints.
    """
    if soft is None:
        soft = SoftParams()
    scene_p = {k: v.detach().clone().requires_grad_(True)
               for k, v in scene_to_params(init_scene).items()}
    cam_p = {k: getattr(camera, k).detach().clone().requires_grad_(True)
             for k in ("position", "yaw", "pitch")}
    all_params = (scene_p, cam_p)
    params = tree_leaves(all_params)
    opt = torch.optim.Adam(params, lr=lr, betas=BETAS, eps=EPS)
    loss_fn = make_loss_fn(camera, soft, config, optimize_camera)

    start_step = 0
    losses = []
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        (saved, (adam, _)), meta = load_state(checkpoint_path,
                                              _state_tree(all_params, opt))
        count, mu, nu = adam
        with torch.no_grad():
            for p, v in zip(params, tree_leaves(saved)):
                p.copy_(v)
        opt.load_state_dict(adam_state_dict(int(count), tree_leaves(mu),
                                             tree_leaves(nu), lr))
        start_step = int(meta["step"])
        losses = list(meta["losses"])

    # Per-pixel inputs: the rays, or the screen coordinates that the loss
    # makes the rays from when the pose is fitted; then the target.
    if optimize_camera:
        pixels = [x.reshape(-1) for x in pixel_uv(config, target.device)]
    else:
        rays = camera_rays(camera, config)
        pixels = [rays.origin.reshape(-1, 3), rays.direction.reshape(-1, 3)]
    pixels.append(target.reshape(-1, 3))

    def loss_of(a, b, tg):
        if optimize_camera:
            return loss_fn(all_params, None, None, tg, uv=(a, b))
        return loss_fn(all_params, a, b, tg)

    writer = True
    if mesh is not None:
        # Imported here: tracer_torch.dist imports this module.
        import torch.distributed as dist
        from tracer_torch.dist.mesh import RAY_AXIS, axis_group, shard_rows
        group, rank, n = axis_group(mesh, RAY_AXIS)
        tiles = max(1, grad_microbatch)
        pixels = [shard_rows(x, rank, n).reshape(tiles, -1, *x.shape[1:])
                  for x in pixels]
        writer = dist.get_rank() == 0
        grad_leaves = params if optimize_camera else tree_leaves(scene_p)

    def sharded_loss():
        """The mean loss over every rank's tiles, with its gradient set on
        the parameters: each tile's loss and gradient, scaled by
        1 / (R * T), summed over the tiles and all-reduced over the ray
        group."""
        scale = 1.0 / (n * tiles)
        bufs, handles = [], []
        for k in range(tiles):
            val = loss_of(*(x[k] for x in pixels))
            grads = torch.autograd.grad(val, grad_leaves)
            buf = torch.cat([(val.detach() * scale).reshape(1)]
                            + [(g * scale).reshape(-1) for g in grads])
            handles.append(dist.all_reduce(buf, group=group, async_op=True))
            bufs.append(buf)
        for h in handles:
            h.wait()
        total = bufs[0]
        for buf in bufs[1:]:
            total = total + buf
        at = 1
        for p in grad_leaves:
            p.grad = total[at:at + p.numel()].reshape(p.shape)
            at += p.numel()
        return total[0]

    def save(step):
        if writer:
            save_state(checkpoint_path, _state_tree(all_params, opt),
                       meta={"step": step, "losses": losses})

    clock = Clock(target.device)
    step_ms = []
    for step in range(start_step, steps):
        clock.start()
        opt.zero_grad()
        if mesh is None:
            val = loss_of(*pixels)
            val.backward()
        else:
            val = sharded_loss()
        # Without optimize_camera the pose stays in the optimiser with zero
        # gradients (the rays do not depend on it).
        for p in cam_p.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        opt.step()
        losses.append(float(val.detach()))
        step_ms.append(clock.stop() * 1e3)
        if checkpoint_path and (step + 1) % checkpoint_every == 0 \
                and step + 1 < steps:
            save(step + 1)
    if checkpoint_path:
        save(steps)

    with torch.no_grad():
        scene = params_to_scene({k: v.detach() for k, v in scene_p.items()})
        cam = (camera.replace(**{k: v.detach() for k, v in cam_p.items()})
               if optimize_camera else camera)
    return FitResult(scene=scene, camera=cam, losses=np.asarray(losses),
                     step_ms=np.asarray(step_ms))
