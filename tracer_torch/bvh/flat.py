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


def node_depths(escape: np.ndarray) -> np.ndarray:
    """Depth of each preorder node: the number of still-open ancestor
    subtrees when it is reached."""
    depth = np.zeros(len(escape), np.int32)
    open_subtrees: list[int] = []
    for i in range(len(escape)):
        while open_subtrees and i >= open_subtrees[-1]:
            open_subtrees.pop()
        depth[i] = len(open_subtrees)
        open_subtrees.append(int(escape[i]))
    return depth


def bvh_stats(bvh: FlatBVH, num_spheres: int) -> dict:
    """Introspection dump, as the JAX ``bvh_stats``: node and leaf counts,
    max depth, mean leaf occupancy, SAH cost (C_trav = C_isect = 1,
    relative to the root's area) and the leaf-depth histogram. Host numpy
    over the tree's arrays (src/bvh_visualiser.c, src/bvh.c:111-115)."""
    M = bvh.num_nodes
    leaf_start = bvh.leaf_start.cpu().numpy()
    node_min = bvh.node_min.cpu().numpy()
    node_max = bvh.node_max.cpu().numpy()
    prim_idx = bvh.prim_idx.cpu().numpy()
    depth = node_depths(bvh.escape.cpu().numpy())

    is_leaf = leaf_start >= 0
    ext = np.maximum(node_max - node_min, 0.0)
    sa = 2.0 * (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2]
                + ext[:, 2] * ext[:, 0])
    root_sa = max(float(sa[0]), 1e-12)
    leaf_counts = np.array([
        int((prim_idx[s: s + bvh.leaf_size] < num_spheres).sum())
        for s in leaf_start[is_leaf]
    ]) if is_leaf.any() else np.zeros(0, np.int32)
    sah = float((sa[~is_leaf].sum() + (sa[is_leaf] * leaf_counts).sum())
                / root_sa)
    return {
        "num_nodes": int(M),
        "num_leaves": int(is_leaf.sum()),
        "max_depth": int(depth.max()) if M else 0,
        "mean_leaf_occupancy": (float(leaf_counts.mean())
                                if len(leaf_counts) else 0.0),
        "sah_cost": sah,
        "leaf_depth_histogram": (np.bincount(depth[is_leaf]).tolist()
                                 if M else []),
    }
