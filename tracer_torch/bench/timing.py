"""Device timing on the card with CUDA events.

PyTorch counterpart of ``tracer/bench/timing.py``. A CUDA stream runs its
work in order and PyTorch neither caches nor drops a call, so no chained
carry is needed: warm up, synchronize, record an event, run ``iters`` calls,
record a second event, synchronize, and divide the elapsed time. Outputs
never feed back into inputs, so a miss (t = +inf) cannot poison later calls.

A call whose kernels take less time than the host takes to issue them is
timed by :func:`time_graph`: captured in a CUDA graph and replayed, so the
host's time drops out of the measurement. :func:`time_host` times calls on
CPU tensors, which finish before they return, on the host clock: the CPU
tests' counterpart of :func:`time_cuda`, never a device time.
"""

from __future__ import annotations

import time

import torch


def time_cuda(fn, *args, warmup: int = 2, iters: int = 10) -> float:
    """Milliseconds per call of ``fn(*args)`` on the current CUDA stream.

    Raises RuntimeError without a CUDA device: a time taken on the CPU is
    not a device time.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("time_cuda needs a CUDA device")
    if iters < 1:
        raise ValueError("iters must be >= 1")
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_host(fn, *args, warmup: int = 1, iters: int = 3) -> float:
    """Milliseconds per call of ``fn(*args)`` on the host clock, for calls
    on CPU tensors (their results are computed before the call returns).

    Raises RuntimeError when an output lies on a CUDA device: a host clock
    around an asynchronous launch measures the enqueue.
    """
    if iters < 1:
        raise ValueError("iters must be >= 1")
    for _ in range(warmup):
        fn(*args)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    ms = (time.perf_counter() - t0) * 1e3 / iters
    leaves = out if isinstance(out, (tuple, list)) else (out,)
    if any(isinstance(x, torch.Tensor) and x.is_cuda for x in leaves):
        raise RuntimeError("time_host times CPU calls; use time_cuda on the "
                           "card")
    return ms


def time_graph(fn, *args, calls: int = 10, replays: int = 5) -> float:
    """Milliseconds of device time per call of ``fn(*args)``: ``calls``
    calls captured in one CUDA graph, the graph replayed ``replays`` times
    between CUDA events. The card then runs the calls' kernels back to back
    whatever the host's time to issue them; each kernel's launch on the
    card stays in. ``fn`` must not synchronize with the host.

    Raises RuntimeError without a CUDA device.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("time_graph needs a CUDA device")
    fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


class Clock:
    """Wall time of one unit of work (a frame, a fit step): CUDA events on
    the card, the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self):
        if self.cuda:
            self.t0 = torch.cuda.Event(enable_timing=True)
            self.t0.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> float:
        """Seconds since start(), after the work queued since has finished."""
        if self.cuda:
            t1 = torch.cuda.Event(enable_timing=True)
            t1.record()
            t1.synchronize()
            return self.t0.elapsed_time(t1) / 1e3
        return time.perf_counter() - self.t0
