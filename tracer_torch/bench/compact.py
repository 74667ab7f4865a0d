"""The row compactor per path: the shapes of its launches and their device
time.

:func:`recording` records every call of the compactor while a path runs;
:func:`report` then gives, for the recorded planes, the launches, a
histogram of their (P, M, keep) shapes, their bytes bound and the device
time of ``compact_cuda`` on them (the path's launches captured in one CUDA
graph and replayed, so the host's time to issue them drops out).
:func:`baseline` builds another compactor source with the same C entry
point ``tracer_compact_rows`` (an older checkout's
``tracer_torch/csrc/compact.cu``), which :func:`report` holds equal to
``compact_cuda`` on every plane and times on the same planes.
``chip_smoke.py`` drives the paths and calls these.
"""

from __future__ import annotations

import contextlib
import ctypes
from collections import Counter
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12
REPLAYS = 5       # replays of a path's planes per timed window


@contextlib.contextmanager
def recording(into: list):
    """Within the block, every call of ``compact_ascending_rows`` (phase A
    of the leaf walks, the tile candidates, the TLAS routing) runs
    unchanged and appends (masked_ids, sentinel, keep) to ``into``."""
    from tracer_torch.intersect import cull as icull
    from tracer_torch.kernels import conecull, tlas
    modules = (conecull, icull, tlas)
    real = conecull.compact_ascending_rows

    def record(masked_ids, sentinel, keep):
        into.append((masked_ids, sentinel, keep))
        return real(masked_ids, sentinel, keep)
    for m in modules:
        m.compact_ascending_rows = record
    try:
        yield into
    finally:
        for m in modules:
            m.compact_ascending_rows = real


def shapes(records) -> dict:
    """{"P x M keep k": launches} over ``records``, by launches."""
    c = Counter(f"{tuple(ids.shape)[0]} x {tuple(ids.shape)[1]} keep "
                f"{min(keep, ids.shape[1])}" for ids, _, keep in records)
    return dict(c.most_common())


def bound_ms(records) -> float:
    """Bytes bound of the launches: each plane read once, each prefix and
    count written once, over the card's memory rate."""
    n = sum(ids.numel() * 4 + ids.shape[0] * (min(keep, ids.shape[1]) + 1)
            * 4 for ids, _, keep in records)
    return n / HBM_BYTES_PER_S * 1e3


def device_ms(fn, records) -> float:
    """Device time of ``fn(ids, sentinel, keep)`` over all the records, in
    ms per pass: the calls captured in one CUDA graph and replayed
    (timing.time_graph), each kernel's launch on the card included."""
    from tracer_torch.bench.timing import time_graph

    def every():
        for r in records:
            fn(*r)
    return time_graph(every, calls=1, replays=REPLAYS) if records else 0.0


def baseline(source: str):
    """``fn(ids, sentinel, keep)`` running the compactor built from
    ``source`` (a .cu file exporting ``tracer_compact_rows``)."""
    from tracer_torch._build import build_shared_library
    from tracer_torch.kernels import _lib
    path, _ = build_shared_library(_lib.nvcc(), _lib.NVCC_FLAGS, ["-shared"],
                                   [Path(source).resolve()],
                                   "libcompact_baseline.so")
    lib = ctypes.CDLL(str(path))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.tracer_compact_rows.restype = i
    lib.tracer_compact_rows.argtypes = [vp] * 3 + [i] * 4 + [vp]

    def fn(ids, sentinel, keep):
        P, M = ids.shape
        keep = min(keep, M)
        out = torch.empty((P, keep), dtype=torch.int32, device=ids.device)
        counts = torch.empty((P,), dtype=torch.int32, device=ids.device)
        rc = lib.tracer_compact_rows(_lib.ptr(ids), _lib.ptr(out),
                                     _lib.ptr(counts), P, M, keep, sentinel,
                                     _lib.stream(ids.device))
        if rc != 0:
            raise RuntimeError(f"baseline compactor: CUDA error {rc}")
        return out, counts
    return fn


def report(records_by_path: dict, base=None, log=print) -> dict:
    """Per path: launches, shapes, the bytes bound and the device time of
    ``compact_cuda`` (and of ``base``, held equal to it on every plane) on
    the recorded planes; logs one line per path and returns them."""
    from tracer_torch.kernels.conecull import compact_cuda
    out = {}
    for name, records in records_by_path.items():
        row = {"launches": len(records), "shapes": shapes(records),
               "bound_ms": bound_ms(records),
               "device_ms": device_ms(compact_cuda, records)}
        if base is not None:
            for r in records:
                want, got = compact_cuda(*r), base(*r)
                if not all(torch.equal(a, b) for a, b in zip(want, got)):
                    raise AssertionError(f"{name}: the baseline compactor "
                                         f"differs from compact_cuda")
            row["baseline_ms"] = device_ms(base, records)
        out[name] = row
        extra = (f", baseline {row['baseline_ms']:.4f} ms" if base is not None
                 else "")
        log(f"compactor, {name}: {row['launches']} launches; device "
            f"{row['device_ms']:.4f} ms{extra}, bound {row['bound_ms']:.4f} "
            f"ms; shapes {row['shapes']}")
    return out
