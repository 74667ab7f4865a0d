"""State carried across from the JAX package as numpy arrays.

Both packages compute on identical state when the scene and the BVH are
built once and handed to each side as numpy arrays: the JAX factories draw
from ``jax.random``, whose stream torch cannot regenerate. Pass
``np.asarray(x)`` of each JAX array; nothing here imports JAX. Tensors go
to the CUDA device unless ``device`` names another (the tests pass "cpu").
"""

from __future__ import annotations

import numpy as np
import torch

from tracer_torch.bvh.flat import FlatBVH
from tracer_torch.core.device import default_device
from tracer_torch.scene.camera import Camera
from tracer_torch.scene.scene import Scene


def _t(a, dtype, device):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                           device=device)


def scene_from_numpy(centers, radii, albedo=None, device=None) -> Scene:
    """(N,3) centers, (N,) radii and optional (N,3) albedo -> Scene
    (albedo defaults to zeros, like ``fixed_scene``)."""
    device = default_device(device)
    c = _t(np.asarray(centers, np.float32).reshape(-1, 3), torch.float32,
           device)
    r = _t(np.asarray(radii, np.float32).reshape(-1), torch.float32, device)
    a = (torch.zeros_like(c) if albedo is None else
         _t(np.asarray(albedo, np.float32).reshape(-1, 3), torch.float32,
            device))
    return Scene(centers=c, radii=r, albedo=a)


def flat_bvh_from_numpy(node_min, node_max, escape, leaf_start, prim_idx,
                        leaf_size: int, device=None) -> FlatBVH:
    """The arrays of a JAX ``FlatBVH`` -> the port's FlatBVH."""
    device = default_device(device)
    return FlatBVH(node_min=_t(node_min, torch.float32, device),
                   node_max=_t(node_max, torch.float32, device),
                   escape=_t(escape, torch.int32, device),
                   leaf_start=_t(leaf_start, torch.int32, device),
                   prim_idx=_t(prim_idx, torch.int32, device),
                   leaf_size=int(leaf_size))


def camera_from_numpy(position, yaw, pitch, fov, device=None) -> Camera:
    """The fields of a JAX ``Camera`` -> the port's Camera (f32 tensors)."""
    device = default_device(device)

    def scalar(x):
        return torch.tensor(np.float32(x), device=device)

    return Camera(position=_t(np.asarray(position, np.float32).reshape(3),
                              torch.float32, device),
                  yaw=scalar(yaw), pitch=scalar(pitch), fov=scalar(fov))


def soft_params_from_numpy(edge_sharpness, tau_depth, smooth_eps):
    """The fields of a JAX ``SoftParams`` -> the port's SoftParams."""
    from tracer_torch.diff.soft import SoftParams
    return SoftParams(edge_sharpness=float(np.float32(edge_sharpness)),
                      tau_depth=float(np.float32(tau_depth)),
                      smooth_eps=float(np.float32(smooth_eps)))


def refit_plan_from_numpy(levels, level_mask, left, right, leaf_ids,
                          device=None):
    """The arrays of a JAX ``RefitPlan`` -> the port's RefitPlan, with its
    index lists on ``device``."""
    from tracer_torch.bvh.refit import plan_from_arrays
    return plan_from_arrays(levels, level_mask, left, right, leaf_ids,
                            default_device(device))


FIT_LEAVES = 19   # 6 parameters, Adam's count, 6 first and 6 second moments


def fit_state_from_jax_checkpoint(path, lr: float = 3e-2, device=None):
    """Read a checkpoint written by the JAX fit with numpy alone.

    Its leaves, in flatten order, are the parameters (albedo_raw, centers,
    radii_raw, pitch, position, yaw), Adam's step count, and the first and
    second moments in parameter order. Returns (params, adam_state, meta):
    params = ({"albedo_raw", "centers", "radii_raw"}, {"pitch",
    "position", "yaw"}) of f32 tensors on ``device``; adam_state a
    ``torch.optim.Adam`` state dict over those six tensors in that order
    (step = the count, exp_avg = the first moments, exp_avg_sq = the
    second) with learning rate ``lr``; meta the checkpoint's metadata.
    """
    import json
    from tracer_torch.diff.fit import adam_state_dict
    device = default_device(device)
    with np.load(path) as f:
        n = sum(k.startswith("leaf_") for k in f.files)
        if n != FIT_LEAVES:
            raise ValueError(f"{path} has {n} leaves, a fit checkpoint has "
                             f"{FIT_LEAVES}")
        leaves = [f[f"leaf_{i}"] for i in range(n)]
        meta = json.loads(bytes(f["__meta__"]).decode()) \
            if "__meta__" in f.files else {}
    t = [_t(a, torch.float32, device) for a in leaves]
    scene = dict(zip(("albedo_raw", "centers", "radii_raw"), t[0:3]))
    cam = dict(zip(("pitch", "position", "yaw"), t[3:6]))
    state = adam_state_dict(int(leaves[6]), t[7:13], t[13:19], lr)
    return (scene, cam), state, meta
