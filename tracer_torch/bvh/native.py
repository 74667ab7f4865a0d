"""ctypes loader for the native C++ binned-SAH builder.

Compiles the JAX package's ``tracer/bvh/native/builder.cpp`` by file path
(the source is shared, the Python package is not imported) with g++ into
``build/tracer_torch/libtracer_bvh.so`` on first use. The ABI is one C
function moving flat arrays in the FlatBVH layout.
"""

from __future__ import annotations

import ctypes
import shutil
import threading

import numpy as np

from tracer_torch._build import REPO_ROOT, build_shared_library

CXX = "g++"
SOURCE = REPO_ROOT / "tracer" / "bvh" / "native" / "builder.cpp"
_lock = threading.Lock()
_lib = None


def available() -> bool:
    """True when the library is built or g++ can build it."""
    return _lib is not None or shutil.which(CXX) is not None


def load() -> ctypes.CDLL:
    """Build (if stale) and load the builder; raises RuntimeError when it
    cannot be built, e.g. without g++."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build_shared_library(
                CXX, ["-O3", "-shared", "-fPIC"], [SOURCE],
                "libtracer_bvh.so", timeout=120)
            lib = ctypes.CDLL(str(path))
            f32p = ctypes.POINTER(ctypes.c_float)
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.tracer_build_bvh.restype = ctypes.c_int
            lib.tracer_build_bvh.argtypes = [
                f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, f32p, f32p, f32p, i32p, i32p, i32p, i32p]
            _lib = lib
        return _lib


def build_bvh_native_arrays(centers: np.ndarray, radii: np.ndarray,
                            leaf_size: int = 4, num_bins: int = 8,
                            max_depth: int = 40,
                            near_point=(0.0, 0.0, 0.0)):
    """Run the C++ builder; returns (node_min, node_max, escape, leaf_start,
    prim_idx) as NumPy arrays."""
    lib = load()
    centers = np.ascontiguousarray(centers, np.float32)
    radii = np.ascontiguousarray(radii, np.float32)
    n = len(radii)
    cap_nodes = 2 * n + 2
    cap_prims = (n + 1) * leaf_size   # every leaf holding one real prim

    node_min = np.empty((cap_nodes, 3), np.float32)
    node_max = np.empty((cap_nodes, 3), np.float32)
    escape = np.empty(cap_nodes, np.int32)
    leaf_start = np.empty(cap_nodes, np.int32)
    prim_idx = np.empty(cap_prims, np.int32)
    sizes = np.zeros(2, np.int32)
    near = np.ascontiguousarray(near_point, np.float32)

    def fp(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def ip(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    rc = lib.tracer_build_bvh(
        fp(centers), fp(radii), n, leaf_size, num_bins, max_depth, fp(near),
        fp(node_min), fp(node_max), ip(escape), ip(leaf_start), ip(prim_idx),
        ip(sizes))
    if rc != 0:
        raise RuntimeError(f"native BVH build failed (rc={rc}, n={n})")
    m, p = int(sizes[0]), int(sizes[1])
    return (node_min[:m].copy(), node_max[:m].copy(), escape[:m].copy(),
            leaf_start[:m].copy(), prim_idx[:p].copy())
