"""Flat, struct-of-arrays BVH in DFS preorder with escape indices.

PyTorch counterpart of ``tracer/bvh/flat.py``. An internal node's left child
is ``i + 1``; ``escape[i]`` is the preorder index right after i's subtree
(``num_nodes`` means done). Leaves are padded to ``leaf_size`` with the
sentinel primitive slot ``num_spheres``; scene arrays gain one never-hit
sphere (far-away center, radius 0) at that index.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import Tensor

SENTINEL_CENTER = 3.0e37
SENTINEL_RADIUS = 0.0


@dataclass
class FlatBVH:
    """Escape-indexed flat BVH over a sphere scene.

    node_min/node_max: (M, 3) f32 node AABBs (src/bvh.c:120-125)
    escape:     (M,) i32 preorder index after the node's subtree (M = done)
    leaf_start: (M,) i32 offset into prim_idx for leaves, -1 for internal
    prim_idx:   (P,) i32 per-leaf primitive slots padded to leaf_size with
                num_spheres (the sentinel); values index the scene arrays
    leaf_size:  int
    """

    node_min: Tensor
    node_max: Tensor
    escape: Tensor
    leaf_start: Tensor
    prim_idx: Tensor
    leaf_size: int = 4

    @property
    def num_nodes(self) -> int:
        return self.node_min.shape[0]


def padded_scene_arrays(centers: Tensor, radii: Tensor):
    """Scene arrays with the sentinel primitive appended at index N."""
    c = torch.cat([centers, torch.full((1, 3), SENTINEL_CENTER,
                                       dtype=centers.dtype,
                                       device=centers.device)])
    r = torch.cat([radii, torch.full((1,), SENTINEL_RADIUS, dtype=radii.dtype,
                                     device=radii.device)])
    return c, r


def validate_bvh(bvh: FlatBVH, centers, radii) -> None:
    """Structural invariants: escape indices form a DFS, leaves partition the
    primitive set, leaf boxes hold their spheres and parents hold children.
    Raises AssertionError on violation."""
    M = bvh.num_nodes
    centers = np.asarray(torch.as_tensor(centers).cpu())
    radii = np.asarray(torch.as_tensor(radii).cpu())
    n = len(radii)
    node_min = bvh.node_min.cpu().numpy()
    node_max = bvh.node_max.cpu().numpy()
    escape = bvh.escape.cpu().numpy()
    leaf_start = bvh.leaf_start.cpu().numpy()
    prim_idx = bvh.prim_idx.cpu().numpy()

    assert ((escape > np.arange(M)) & (escape <= M)).all(), "bad escape indices"

    real = prim_idx[prim_idx < n]
    assert len(real) == n and len(np.unique(real)) == n, \
        "leaves must partition the primitive set"

    L = bvh.leaf_size
    for i in range(M):
        if leaf_start[i] >= 0:
            slots = prim_idx[leaf_start[i]: leaf_start[i] + L]
            slots = slots[slots < n]
            lo = centers[slots] - radii[slots, None]
            hi = centers[slots] + radii[slots, None]
            assert (lo >= node_min[i] - 1e-4).all(), f"leaf {i} prim below box"
            assert (hi <= node_max[i] + 1e-4).all(), f"leaf {i} prim above box"
        else:
            for ch in (i + 1, escape[i + 1]):
                if np.isnan(node_min[ch]).any():
                    continue
                assert (node_min[ch] >= node_min[i] - 1e-4).all()
                assert (node_max[ch] <= node_max[i] + 1e-4).all()
