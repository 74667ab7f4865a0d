"""Inverse rendering: fit scene geometry, material and camera to a target
image (BASELINE config 4).

PyTorch counterpart of ``tracer/diff/fit.py`` on one device. Gradient
descent on the smoothed forward model (:mod:`tracer_torch.diff.soft`):
pixels -> MSE loss -> autograd -> Adam updates of sphere centres, radii and
albedo. Radii are parameterised through softplus to stay positive, albedo
through a sigmoid to stay in [0, 1].

The optimiser is ``torch.optim.Adam`` (betas 0.9 / 0.999, eps 1e-8), the
update of ``optax.adam``. The camera's position, yaw and pitch are in it
too, with zero gradients: the rays are generated once from the initial
camera, as in the JAX fit, so the loss does not reach the pose. The
optimiser state therefore has the JAX state's leaves, and a checkpoint
(:mod:`tracer_torch.checkpoint`) holds, in flatten order: the six
parameters (albedo_raw, centers, radii_raw, pitch, position, yaw), Adam's
step count (int32), then its first and second moments in parameter order;
19 leaves, the layout of a checkpoint the JAX fit writes, which this fit
resumes from. The JAX fit's mesh and gradient-microbatch options (rays
sharded across devices) are not ported.
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
from tracer_torch.scene.camera import Camera, camera_rays
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
    """loss_fn((scene_params, cam_params), ray_o, ray_d, target) -> the
    mean squared error of the soft image of the given rays."""
    def loss_fn(all_params, ray_o, ray_d, target):
        scene_params, cam_params = all_params
        cam = camera.replace(**cam_params) if optimize_camera else camera
        rays = Ray(origin=ray_o, direction=ray_d)
        img = soft_render(params_to_scene(scene_params), cam, soft, config,
                          rays=rays)
        return torch.mean((img - target) ** 2)
    return loss_fn


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
              checkpoint_path: str | None = None,
              checkpoint_every: int = 50,
              resume: bool = False) -> FitResult:
    """Fit the scene (and, nominally, the camera pose) to ``target`` (H, W,
    3) on the device the inputs live on.

    With ``checkpoint_path`` the whole optimisation state (parameters, Adam
    moments, step count, loss history) is saved every ``checkpoint_every``
    steps and at the end (:func:`tracer_torch.checkpoint.save_state`); with
    ``resume=True`` a killed run continues from the last checkpoint, and
    the remaining steps are bitwise those of an uninterrupted run.
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

    rays = camera_rays(camera, config)
    ray_o = rays.origin.reshape(-1, 3)
    ray_d = rays.direction.reshape(-1, 3)
    target_flat = target.reshape(-1, 3)

    def save(step):
        save_state(checkpoint_path, _state_tree(all_params, opt),
                   meta={"step": step, "losses": losses})

    clock = Clock(target.device)
    step_ms = []
    for step in range(start_step, steps):
        clock.start()
        opt.zero_grad()
        val = loss_fn(all_params, ray_o, ray_d, target_flat)
        val.backward()
        # The pose stays in the optimiser with zero gradients, as in the
        # JAX fit (its loss never reaches the pose: the rays are fixed).
        for p in cam_p.values():
            if p.grad is None or not optimize_camera:
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
