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
