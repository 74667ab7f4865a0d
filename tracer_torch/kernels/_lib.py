"""Builds and loads the hand-written CUDA kernels under ``tracer_torch/csrc``.

Each source is compiled with nvcc for Hopper (``sm_90a``), one nvcc process
per source, all started together, and the objects are linked into one shared
library with a plain C interface, ``build/tracer_torch/libtracer_torch_cuda.so``,
on first use, and loaded with ctypes. Every kernel wrapper launches through
:func:`launch`: pointers and the CUDA stream go in as ``c_void_p``, every
entry point returns ``cudaGetLastError()`` after its launch (floats go in
as ``c_float``), :func:`check`
raises on a non-zero code, and ``launches`` counts the launches by wrapper.
Nothing here runs when the module is imported.
"""

from __future__ import annotations

import collections
import ctypes
import os
import shutil
import threading
import time
from pathlib import Path

import torch

from tracer_torch._build import build_shared_library

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "libtracer_torch_cuda.so"

_lock = threading.Lock()
_lib = None
build_seconds = 0.0
build_log = ""
# Launches by kernel wrapper ("leafcull_cuda", ...), one per call of
# :func:`launch`, for the CPU guards and the on-card checks.
launches: collections.Counter = collections.Counter()


def nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def load() -> ctypes.CDLL:
    """Build the kernels if stale, load them once per process."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            t0 = time.perf_counter()
            path, build_log = build_shared_library(
                nvcc(), NVCC_FLAGS, ["-shared"], sorted(CSRC.glob("*.cu")),
                LIB_NAME, depends=sorted(CSRC.glob("*.cuh")))
            build_seconds = time.perf_counter() - t0
            lib = ctypes.CDLL(str(path))
            vp, i = ctypes.c_void_p, ctypes.c_int
            lib.tracer_leafcull.restype = i
            lib.tracer_leafcull.argtypes = [vp] * 7 + [i] * 9 + [vp]
            lib.tracer_compact_rows.restype = i
            lib.tracer_compact_rows.argtypes = [vp] * 3 + [i] * 4 + [vp]
            lib.tracer_anyhit.restype = i
            lib.tracer_anyhit.argtypes = [vp] * 5 + [i] * 9 + [vp]
            lib.tracer_routed.restype = i
            lib.tracer_routed.argtypes = [vp] * 9 + [i] * 8 + [vp]
            lib.tracer_traverse.restype = i
            lib.tracer_traverse.argtypes = [vp] * 8 + [i] * 5 + [vp]
            lib.tracer_tilecull.restype = i
            lib.tracer_tilecull.argtypes = [vp] * 5 + [i] * 3 + [vp]
            lib.tracer_conecull.restype = i
            lib.tracer_conecull.argtypes = [vp] * 9 + [i] * 9 + [vp]
            lib.tracer_cull.restype = i
            lib.tracer_cull.argtypes = [vp] * 6 + [i] * 3 + [vp]
            lib.tracer_phase_a.restype = i
            lib.tracer_phase_a.argtypes = [vp] * 9 + [i] * 12 + [vp]
            lib.tracer_phase_a_chunks.restype = i
            lib.tracer_phase_a_chunks.argtypes = [vp] * 6 + [i] * 12 + [vp]
            lib.tracer_prep_keys.restype = i
            lib.tracer_prep_keys.argtypes = [vp] * 2 + [i] + [vp]
            lib.tracer_prep_cells.restype = i
            lib.tracer_prep_cells.argtypes = [vp] * 2 + [i] * 3 + [vp]
            lib.tracer_prep_rows.restype = i
            lib.tracer_prep_rows.argtypes = [vp] * 8 + [i] * 4 + [vp]
            f = ctypes.c_float
            lib.tracer_soft_gather.restype = i
            lib.tracer_soft_gather.argtypes = [vp] * 10 + [i] * 3 + [vp]
            lib.tracer_soft_rays.restype = i
            lib.tracer_soft_rays.argtypes = [vp] * 13 + [i] * 7 + [f] * 3 \
                + [vp]
            lib.tracer_soft_grads.restype = i
            lib.tracer_soft_grads.argtypes = [vp] * 11 + [i] * 4 + [f] * 2 \
                + [vp]
            lib.tracer_cuda_error_string.restype = ctypes.c_char_p
            lib.tracer_cuda_error_string.argtypes = [i]
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.tracer_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def stream(device: torch.device) -> int:
    """The raw ``cudaStream_t`` of ``device``'s current stream."""
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    return torch._C._cuda_getCurrentRawStream(index)


def launch(name: str, entry: str, device: torch.device, *args) -> None:
    """Call the library's ``entry`` on ``device`` with ``args`` (tensors as
    their pointers, ``None`` as a null pointer, ints as they are) and the
    device's current stream; raise on a non-zero code, else add one to
    ``launches[name]``."""
    lib = load()
    with torch.cuda.device(device):
        rc = getattr(lib, entry)(
            *(ptr(a) if isinstance(a, torch.Tensor) else a for a in args),
            stream(device))
    check(lib, rc, name)
    launches[name] += 1


def require_cuda(what: str, *tensors: torch.Tensor) -> torch.device:
    """The one device all ``tensors`` share; raises unless it is CUDA."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {t.device} and {dev}")
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on CUDA tensors, got {dev}")
    return dev
