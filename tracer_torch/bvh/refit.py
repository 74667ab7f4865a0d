"""BVH refit on the device: new bounds for moved or resized spheres.

PyTorch counterpart of ``tracer/bvh/refit.py``. Geometry is a parameter of
the fit, so bounds must track it without a rebuild. Refit keeps the tree's
topology (built on the host) and recomputes every node's box from the
current centres and radii on the device:

  * leaf boxes: one gather and a masked min/max over each leaf's
    ``leaf_size`` primitive slots;
  * internal boxes: the union of the two children, level by level from the
    lowest height up. In escape-indexed preorder a node's children are
    ``i + 1`` and ``escape[i + 1]``; heights are a property of the
    topology, so the host plans the levels once (:class:`RefitPlan`).

Each level is an out-of-place ``index_put`` of its own nodes, which are
unique: differentiable, with no scatter-reduce and no padding. The plan's
padded arrays equal the JAX plan's; the device pass reads only the real
entries of each level.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch
from torch import Tensor

from tracer_torch.bvh.flat import FlatBVH

_EMPTY = 3.0e37  # collapsed box of slots that hold no sphere


@dataclass
class RefitPlan:
    """Topology schedule for :func:`refit_bvh`.

    levels: (H, W) int32 internal-node indices by height (1 = parents of
        leaves), each row padded with node 0 and masked by ``level_mask``;
        height-h nodes depend only on lower heights.
    level_mask: (H, W) bool.
    left/right: (M,) int32 children (left = i + 1, right = escape[i + 1]);
        arbitrary for leaves.
    leaf_ids: (L,) int32 preorder indices of the leaves in leaf_start order.
    The numpy arrays above are the host plan; ``level_nodes``,
    ``level_left`` and ``level_right`` hold each level's real nodes and
    their children as int64 tensors, and ``leaf_index`` the leaves, on the
    device the refit runs on.
    """

    levels: np.ndarray
    level_mask: np.ndarray
    left: np.ndarray
    right: np.ndarray
    leaf_ids: np.ndarray
    level_nodes: list
    level_left: list
    level_right: list
    leaf_index: Tensor


def plan_from_arrays(levels, level_mask, left, right, leaf_ids,
                     device) -> RefitPlan:
    """A RefitPlan from its host arrays, with the device index lists."""
    levels = np.asarray(levels, np.int32)
    level_mask = np.asarray(level_mask, bool)
    left = np.asarray(left, np.int32)
    right = np.asarray(right, np.int32)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    nodes = [levels[h][level_mask[h]] for h in range(levels.shape[0])]
    return RefitPlan(levels=levels, level_mask=level_mask, left=left,
                     right=right, leaf_ids=np.asarray(leaf_ids, np.int32),
                     level_nodes=[t(n) for n in nodes],
                     level_left=[t(left[n]) for n in nodes],
                     level_right=[t(right[n]) for n in nodes],
                     leaf_index=t(leaf_ids))


def build_refit_plan(bvh: FlatBVH, device=None) -> RefitPlan:
    """Host-side, once per topology (numpy); the index lists go to
    ``device`` (the tree's device by default)."""
    escape = bvh.escape.cpu().numpy()
    leaf_start = bvh.leaf_start.cpu().numpy()
    M = bvh.num_nodes
    is_leaf = leaf_start >= 0

    left = np.minimum(np.arange(M) + 1, M - 1)
    right = np.minimum(escape[left], M - 1)

    height = np.zeros(M, np.int32)
    for i in range(M - 1, -1, -1):          # children are always > parent
        if not is_leaf[i]:
            height[i] = 1 + max(height[left[i]], height[right[i]])

    hmax = int(height.max()) if M else 0
    per_level = [np.where(~is_leaf & (height == h))[0]
                 for h in range(1, hmax + 1)]
    w = max((len(x) for x in per_level), default=1)
    levels = np.zeros((len(per_level), max(w, 1)), np.int32)
    mask = np.zeros_like(levels, bool)
    for h, idx in enumerate(per_level):
        levels[h, :len(idx)] = idx
        mask[h, :len(idx)] = True

    order = np.argsort(leaf_start[is_leaf], kind="stable")
    leaf_ids = np.where(is_leaf)[0][order]
    return plan_from_arrays(levels, mask, left, right, leaf_ids,
                            bvh.node_min.device if device is None
                            else device)


def refit_bvh(bvh: FlatBVH, plan: RefitPlan, centers: Tensor,
              radii: Tensor) -> FlatBVH:
    """A FlatBVH with bounds recomputed for ``centers``/``radii``;
    topology, escape and prim_idx unchanged. Differentiable in both."""
    n = centers.shape[0]
    L = bvh.leaf_size

    # Leaf boxes: (leaves, leaf_size) prim slots, sentinel-masked.
    pid = bvh.prim_idx.reshape(plan.leaf_index.shape[0], L).long()
    real = (pid < n)[..., None]
    safe = torch.clamp(pid, max=n - 1)
    c = centers[safe]                              # (leaves, leaf_size, 3)
    r = radii[safe][..., None]
    empty = torch.full((), _EMPTY, dtype=c.dtype, device=c.device)
    lo = torch.where(real, c - r, empty).amin(dim=1)
    hi = torch.where(real, c + r, -empty).amax(dim=1)

    node_min = torch.full_like(bvh.node_min, _EMPTY) \
        .index_put((plan.leaf_index,), lo)
    node_max = torch.full_like(bvh.node_max, -_EMPTY) \
        .index_put((plan.leaf_index,), hi)
    # Levels apply in height order; each writes only its own nodes.
    for idx, lc, rc in zip(plan.level_nodes, plan.level_left,
                           plan.level_right):
        node_min = node_min.index_put(
            (idx,), torch.minimum(node_min[lc], node_min[rc]))
        node_max = node_max.index_put(
            (idx,), torch.maximum(node_max[lc], node_max[rc]))
    return replace(bvh, node_min=node_min, node_max=node_max)
