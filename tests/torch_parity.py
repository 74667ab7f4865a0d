"""Shared inputs and converters for the PyTorch-port parity tests.

Both packages take the same seeded numpy arrays: the JAX scene factories
draw from ``jax.random``, which torch cannot reproduce, so scenes, BVHs and
rays are made once here and handed to each side. The JAX side runs on the
CPU as its own tests do (Pallas kernels in interpret mode); the port runs
its plain PyTorch versions on CPU tensors.
"""

import jax.numpy as jnp
import numpy as np
import torch

import tracer_torch as tt
from tracer.bvh.builder import build_bvh as jax_build_bvh
from tracer.scene.scene import fixed_scene

S, SP, CELL_BITS = 4, 64, 4      # small packets for CPU-sized tests


def np_(x) -> np.ndarray:
    """A writable numpy copy of a JAX array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    return np.array(x)


def to_torch(x) -> torch.Tensor:
    return torch.as_tensor(np_(x))


def to_jax(x):
    return jnp.asarray(np_(x))


def scene_np(n: int, seed: int = 3, world: float = 60.0,
             radius: float = 0.5):
    """(centers, radii, albedo) of the benchmark distribution: n spheres of
    one radius uniform in a centered cube of side ``world``."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-world / 2, world / 2, (n, 3)).astype(np.float32)
    r = np.full(n, radius, np.float32)
    a = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return c, r, a


def origin_rays_np(b: int, seed: int = 0):
    """(origins, unit directions) of b origin rays, uniform-cube dirs."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(-1, 1, (b, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.zeros_like(d), d


def scenes(c, r, a):
    """The same scene for both packages: (JAX Scene, port Scene)."""
    return fixed_scene(c, r, a), tt.scene_from_numpy(c, r, a)


def bvhs(c, r, leaf_size: int):
    """One JAX BVH and the port's copy of it: (JAX FlatBVH, port FlatBVH)."""
    jb = jax_build_bvh(c, r, leaf_size=leaf_size)
    return jb, bvh_from_jax(jb)


def bvh_from_jax(jb):
    return tt.flat_bvh_from_numpy(np_(jb.node_min), np_(jb.node_max),
                                  np_(jb.escape), np_(jb.leaf_start),
                                  np_(jb.prim_idx), jb.leaf_size)


def assert_walk_t_close(t, t_ref, feats, slot, prims, rtol=1e-5):
    """Leaf-walk t (G, SP, S) against a reference at every hit slot.

    XLA on the CPU contracts mul+add into FMA where torch rounds each op,
    so the two differ by an ulp or so inside disc = b'^2 - a*c'. That is
    below ``rtol`` except on grazing rays (disc < 1e-3 * b'^2), where the
    sqrt amplifies it: there t may also differ by the propagated bound
    2^-20 * b'^2 / (a * sqrt(disc)), i.e. 16 ulps of b'^2 through the root.
    """
    f = np_(feats).transpose(0, 2, 1, 3).reshape(-1, feats.shape[-1])
    s = np_(slot).reshape(-1)
    hit = s < 2 ** 30
    f = f[hit].astype(np.float64)
    q = np_(prims).reshape(-1, 4)[s[hit]].astype(np.float64)
    bp = f[:, 8] - (f[:, 0:3] * q[:, 0:3]).sum(1)
    cq = (f[:, 3:6] * q[:, 0:3]).sum(1) + q[:, 3] + f[:, 9]
    disc = bp * bp - f[:, 10] * cq
    graze = disc < 1e-3 * bp * bp
    got, want = np_(t).reshape(-1)[hit], np_(t_ref).reshape(-1)[hit]
    tol = rtol * np.abs(want) + np.where(
        graze, 2.0 ** -20 * bp * bp / (f[:, 10] * np.sqrt(np.maximum(
            disc, 1e-30))), 0.0)
    bad = np.abs(got - want) > tol
    assert not bad.any(), (f"{bad.sum()} of {hit.sum()} hits outside "
                           f"tolerance ({graze.sum()} grazing)")


def entries_to_prims(entries, leaf_size: int) -> np.ndarray:
    """JAX pair-packed, lane-replicated entries (C, Ec+1, 8, 128) -> the
    port's slot-major (C, lpc*leaf_size, 4) prim table layout."""
    e = np_(entries)[:, :-1]                        # drop the sentinel
    C, E = e.shape[:2]
    e = e[..., :leaf_size].reshape(C, E, 2, 4, leaf_size)  # leaf, attr, prim
    return e.transpose(0, 1, 2, 4, 3).reshape(C, E * 2 * leaf_size, 4)
