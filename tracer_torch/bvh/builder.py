"""Binned-SAH BVH construction on the host (NumPy or native C++).

PyTorch counterpart of ``tracer/bvh/builder.py``: the reference's top-down
SAH build (``build_bvh_node``, src/bvh.c:117-207) with 8 uniform planes per
axis (src/bvh.c:143-160), partition by sphere center (src/bvh.c:172-201) and
cost ``0.125 + Nl*SAl + Nr*SAr`` (src/bvh.c:59-97), binned to O(n * bins)
per level. Degenerate partitions fall back to an exact median split, and
leaves hold up to ``leaf_size`` spheres. The output is escape-indexed
preorder (tracer_torch/bvh/flat.py); only the final arrays become tensors.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tracer_torch.bvh import native
from tracer_torch.bvh.flat import FlatBVH
from tracer_torch.core.device import default_device


def _surface_area(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """2*(xy+yz+zx) of extents hi-lo; empty boxes clamp to 0 extent.
    Reference ``get_aabb_surface_area`` (src/bvh.c:48-57)."""
    d = np.maximum(hi - lo, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                  + d[..., 2] * d[..., 0])


def _flat(node_min, node_max, escape, leaf_start, prim_idx, leaf_size,
          device) -> FlatBVH:
    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return FlatBVH(node_min=t(node_min, torch.float32),
                   node_max=t(node_max, torch.float32),
                   escape=t(escape, torch.int32),
                   leaf_start=t(leaf_start, torch.int32),
                   prim_idx=t(prim_idx, torch.int32),
                   leaf_size=leaf_size)


def build_bvh(centers, radii, leaf_size: int = 4, num_bins: int = 8,
              max_depth: int = 40, backend: str = "auto",
              near_point=(0.0, 0.0, 0.0), device=None) -> FlatBVH:
    """Build a FlatBVH over spheres. centers (N,3), radii (N,) (host arrays
    or tensors). Primitive indices reference the caller's sphere order.

    backend: "native" runs the C++ builder and raises RuntimeError when it
    cannot be built (no g++); "numpy" runs the NumPy builder; "auto" takes
    native when g++ or a built library is there, else NumPy. near_point
    (native only): children are emitted closer-to-this-point first.
    The tree goes to the CUDA device unless ``device`` names another;
    without CUDA and without ``device`` this raises before building.
    """
    if backend not in ("auto", "native", "numpy"):
        raise ValueError(f"unknown backend {backend!r}")
    centers = np.asarray(torch.as_tensor(centers).cpu(), np.float32)
    radii = np.asarray(torch.as_tensor(radii).cpu(), np.float32)
    n = len(radii)
    if n == 0:
        raise ValueError("cannot build a BVH over an empty scene")
    device = default_device(device)

    if backend == "native" or (backend == "auto" and native.available()):
        arrays = native.build_bvh_native_arrays(
            centers, radii, leaf_size=leaf_size, num_bins=num_bins,
            max_depth=max_depth, near_point=near_point)
        return _flat(*arrays, leaf_size, device)

    prim_lo = centers - radii[:, None]
    prim_hi = centers + radii[:, None]

    node_min: list[np.ndarray] = []
    node_max: list[np.ndarray] = []
    escape: list[int] = []
    leaf_start: list[int] = []
    prim_slots: list[np.ndarray] = []

    def sah_split(idx, lo, hi):
        """Binned SAH split; (left_idx, right_idx) or None if every
        candidate plane is degenerate."""
        c = centers[idx]
        best = None  # (cost, axis, plane_bin)
        for axis in range(3):
            span = float(hi[axis] - lo[axis])
            if span <= 0.0:
                continue
            t = (c[:, axis] - lo[axis]) / span
            b = np.clip((t * num_bins).astype(np.int64), 0, num_bins - 1)
            counts = np.bincount(b, minlength=num_bins)
            bin_lo = np.full((num_bins, 3), np.inf, np.float32)
            bin_hi = np.full((num_bins, 3), -np.inf, np.float32)
            np.minimum.at(bin_lo, b, prim_lo[idx])
            np.maximum.at(bin_hi, b, prim_hi[idx])
            pre_lo = np.minimum.accumulate(bin_lo, axis=0)
            pre_hi = np.maximum.accumulate(bin_hi, axis=0)
            suf_lo = np.minimum.accumulate(bin_lo[::-1], axis=0)[::-1]
            suf_hi = np.maximum.accumulate(bin_hi[::-1], axis=0)[::-1]
            n_left = np.cumsum(counts)[:-1]
            n_right = len(idx) - n_left
            sa_left = _surface_area(pre_lo[:-1], pre_hi[:-1])
            sa_right = _surface_area(suf_lo[1:], suf_hi[1:])
            cost = 0.125 + np.where(n_left > 0, n_left * sa_left, 0.0) \
                         + np.where(n_right > 0, n_right * sa_right, 0.0)
            usable = (n_left > 0) & (n_right > 0)
            if not usable.any():
                continue
            cost = np.where(usable, cost, np.inf)
            k = int(np.argmin(cost))
            if best is None or cost[k] < best[0]:
                best = (float(cost[k]), axis, k)

        if best is None:
            return None
        _, axis, k = best
        span = float(hi[axis] - lo[axis])
        t = (centers[idx, axis] - lo[axis]) / span
        b = np.clip((t * num_bins).astype(np.int64), 0, num_bins - 1)
        mask = b <= k
        return idx[mask], idx[~mask]

    def median_split(idx, lo, hi):
        """Exact median split on the longest axis: always progresses."""
        axis = int(np.argmax(hi - lo))
        ordr = np.argsort(centers[idx, axis], kind="stable")
        half = max(len(idx) // 2, 1)
        return idx[ordr[:half]], idx[ordr[half:]]

    def emit(idx: np.ndarray, depth: int) -> None:
        me = len(node_min)
        node_min.append(prim_lo[idx].min(axis=0))
        node_max.append(prim_hi[idx].max(axis=0))
        escape.append(-1)
        leaf_start.append(-1)

        if len(idx) <= leaf_size:
            padded = np.full(leaf_size, n, np.int64)
            padded[:len(idx)] = idx
            leaf_start[me] = len(prim_slots) * leaf_size
            prim_slots.append(padded)
            escape[me] = me + 1
            return

        split = None if depth >= max_depth else sah_split(
            idx, node_min[me], node_max[me])
        if split is None:
            split = median_split(idx, node_min[me], node_max[me])
        left_idx, right_idx = split
        emit(left_idx, depth + 1)
        emit(right_idx, depth + 1)
        escape[me] = len(node_min)  # index right past my whole subtree

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        emit(np.arange(n), 0)
    finally:
        sys.setrecursionlimit(old_limit)

    return _flat(np.stack(node_min), np.stack(node_max), escape, leaf_start,
                 np.concatenate(prim_slots), leaf_size, device)
