"""Sharded inverse-rendering training step on a 2-D (rays x scene) mesh.

PyTorch counterpart of ``tracer/dist/train.py``, the analog of a DP x TP
sharded model update:

  * ``rays`` axis (DP): rays and target pixels shard; every rank computes
    the loss on its ray block, and the parameter gradients are all-reduced
    over the ray group.
  * ``scene`` axis (TP): the sphere arrays shard. Each rank scores its
    sphere shard against its rays, keeps each ray's ``k_top`` largest-sigma
    candidates as (sigma, t, shade), all-gathers the candidate sets over
    the scene group (an all-gather recorded for autograd, whose backward
    sums over the group), and runs the depth-ordered composite the renderer
    ships (``diff.soft.composite_sorted``) on the merged set. Each rank
    updates only its sphere shard with ``torch.optim.Adam``.

The loss is the mean over all rays. With ``k_top`` at least the shard size
every sphere is a candidate and it equals the unsharded ``soft_render``
loss. A smaller budget drops each shard's candidates below its k-th largest
sigma, and then the loss equals the unsharded one only up to the dropped
tail: each dropped candidate moves a ray's colour by at most 1.5 times its
sigma (a shade lies in [0, 1.5]), so with a target in [0, 1] the loss moves
by at most 3 times the mean over rays of the sum of their dropped sigmas.
(The JAX package's docstring claims equality whatever the budget.)

The gradient is the gradient of that mean loss with respect to each rank's
sphere shard. Two sums are undone by dividing the all-reduced gradient by
R * S, for R ray and S scene shards: every scene rank of a ray row computes
the same loss from the same gathered candidates, so the all-gather's
backward gives S times each shard's gradient; and the all-reduce over the
ray group sums the R ray blocks' gradients of their own mean losses, R
times the gradient of the mean over all rays. The JAX package's step keeps
both sums, so its gradient is R * S times this one.

SPMD like the rest of :mod:`tracer_torch.dist`: every rank passes the full
parameters, Adam state, rays and targets, takes its shards, and gets the
full updated parameters and state back (gathered over the scene group).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
from torch import Tensor
from torch.distributed.device_mesh import DeviceMesh

from tracer_torch.diff.fit import (BETAS, EPS, adam_state_dict,
                                   params_to_scene, scene_to_params)
from tracer_torch.diff.soft import SoftParams, _shade_sigma_t, composite_sorted
from tracer_torch.dist.mesh import (RAY_AXIS, SCENE_AXIS, all_gather_cat,
                                    all_gather_cat_grad, axis_group,
                                    shard_rows)
from tracer_torch.scene.scene import Scene


class AdamState(NamedTuple):
    """Adam's state for a parameter dict: the step count and the first and
    second moments (dicts shaped like the parameters)."""

    count: int
    mu: dict
    nu: dict


def _gather_shards(shards: list[Tensor], group) -> list[Tensor]:
    """Each tensor's shards concatenated along dim 0 in group-rank order,
    with one all-gather for all of them (every rank's shards have the same
    shapes)."""
    flat = torch.cat([x.reshape(-1) for x in shards])
    got = all_gather_cat(flat, group).reshape(dist.get_world_size(group), -1)
    out, at = [], 0
    for x in shards:
        k = x.numel()
        out.append(got[:, at:at + k].reshape(-1, *x.shape[1:]))
        at += k
    return out


def make_train_step(mesh: DeviceMesh, soft: SoftParams | None = None,
                    lr: float = 1e-2, k_top: int = 16):
    """Build (init_fn, step_fn_factory) for the sharded training step.

    init_fn(scene) -> (params, opt_state)
    step_fn_factory(opt_state) -> step_fn
    step_fn(params, opt_state, ray_o, ray_d, target)
        -> (params, opt_state, loss)

    ``params`` is the dict of :func:`diff.fit.scene_to_params` and
    ``opt_state`` an :class:`AdamState`, both full on every rank; the
    sphere dimension is sharded over the scene group inside the step, the
    rays (B, 3) and targets (B, 3) over the ray group. ``loss`` is the mean
    over all rays, the same on every rank. ``k_top`` is the per-shard
    candidate budget of the merged composite.
    """
    if soft is None:
        soft = SoftParams()
    rgroup, ri, R = axis_group(mesh, RAY_AXIS)
    sgroup, si, S = axis_group(mesh, SCENE_AXIS)

    def init_fn(scene: Scene):
        params = {k: v.detach().clone()
                  for k, v in scene_to_params(scene).items()}
        return params, AdamState(
            count=0, mu={k: torch.zeros_like(v) for k, v in params.items()},
            nu={k: torch.zeros_like(v) for k, v in params.items()})

    def loss_of(local: dict, o: Tensor, d: Tensor, target: Tensor):
        sigma, shade, t = _shade_sigma_t(params_to_scene(local), o, d, soft)
        k = min(k_top, sigma.shape[1])
        # Per-shard top-k; the indices are piecewise constant, the values
        # carry the gradients.
        sig_k, idx = torch.topk(sigma, k, dim=1)
        t_k = torch.gather(t, 1, idx)
        shade_k = torch.gather(shade, 1, idx[..., None].expand(-1, -1, 3))
        cand = torch.cat([sig_k[..., None], t_k[..., None], shade_k], -1)
        cand = all_gather_cat_grad(cand, sgroup, dim=1)    # (b, k*S, 5)
        img = composite_sorted(cand[..., 0], cand[..., 2:5], cand[..., 1], d)
        return torch.mean((img - target) ** 2)

    def step_fn(params: dict, opt_state: AdamState, ray_o: Tensor,
                ray_d: Tensor, target: Tensor):
        keys = sorted(params)
        local = {k: shard_rows(params[k], si, S).detach().clone()
                 .requires_grad_(True) for k in keys}
        o, d, tg = (shard_rows(x, ri, R) for x in (ray_o, ray_d, target))
        loss = loss_of(local, o, d, tg)
        grads = torch.autograd.grad(loss, [local[k] for k in keys])
        # The gradient all-reduce over the ray group, divided by R * S into
        # the gradient of the mean loss (see the module docstring).
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=rgroup)
        flat = flat / (R * S)
        at = 0
        for k in keys:
            n = local[k].numel()
            local[k].grad = flat[at:at + n].reshape(local[k].shape)
            at += n
        loss = loss.detach() / R
        dist.all_reduce(loss, group=rgroup)
        loss = loss / S
        dist.all_reduce(loss, group=sgroup)

        opt = torch.optim.Adam([local[k] for k in keys], lr=lr, betas=BETAS,
                               eps=EPS)
        opt.load_state_dict(adam_state_dict(
            opt_state.count,
            [shard_rows(opt_state.mu[k], si, S).clone() for k in keys],
            [shard_rows(opt_state.nu[k], si, S).clone() for k in keys], lr))
        opt.step()
        st = [opt.state[local[k]] for k in keys]
        full = _gather_shards([local[k].detach() for k in keys]
                              + [s["exp_avg"] for s in st]
                              + [s["exp_avg_sq"] for s in st], sgroup)
        m = len(keys)
        return (dict(zip(keys, full[:m])),
                AdamState(count=opt_state.count + 1,
                          mu=dict(zip(keys, full[m:2 * m])),
                          nu=dict(zip(keys, full[2 * m:]))),
                loss)

    def step_fn_factory(opt_state_example: AdamState):
        return step_fn

    return init_fn, step_fn_factory
