"""Builds and loads the hand-written CUDA kernels under ``tracer_torch/csrc``.

The sources are compiled with nvcc for Hopper (``sm_90a``) into one shared
library with a plain C interface, ``build/tracer_torch/libtracer_torch_cuda.so``,
on first use, and loaded with ctypes. Pointers and the CUDA stream go in as
``c_void_p``; every entry point returns ``cudaGetLastError()`` after its
launch, and :func:`check` raises on a non-zero code. Nothing here runs when
the module is imported.
"""

from __future__ import annotations

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
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "libtracer_torch_cuda.so"

_lock = threading.Lock()
_lib = None
build_seconds = 0.0
build_log = ""


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
    with _lock:
        if _lib is None:
            t0 = time.perf_counter()
            path, build_log = build_shared_library(
                nvcc(), NVCC_FLAGS, sorted(CSRC.glob("*.cu")), LIB_NAME)
            build_seconds = time.perf_counter() - t0
            lib = ctypes.CDLL(str(path))
            vp, i = ctypes.c_void_p, ctypes.c_int
            lib.tracer_leafcull.restype = i
            lib.tracer_leafcull.argtypes = [vp] * 5 + [i] * 8 + [vp]
            lib.tracer_compact_rows.restype = i
            lib.tracer_compact_rows.argtypes = [vp] * 3 + [i] * 4 + [vp]
            lib.tracer_cuda_error_string.restype = ctypes.c_char_p
            lib.tracer_cuda_error_string.argtypes = [i]
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.tracer_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def require_cuda(what: str, *tensors: torch.Tensor) -> torch.device:
    """The one device all ``tensors`` share; raises unless it is CUDA."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {t.device} and {dev}")
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on CUDA tensors, got {dev}")
    return dev
