"""Clocks of the benchmark: the closed loop's window on the host clock and
CUDA-event spans around the calls it makes into the port.

The event arithmetic is ``tracer_torch.bench.timing.time_cuda``'s: record an
event, run, record a second, synchronise, read ``elapsed_time``. Here each
request is one span set, read after the request's own synchronise, never a
mean of back-to-back calls.
"""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function

RANGE = "bm."

def sync(device: torch.device) -> None:
    """Wait for the device: ends every request of the closed loop."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """CUDA-event spans of one request, named in the order they are taken:
    ``mark(name)`` closes the open span and opens ``name``; ``close()``
    closes the last. ``read()`` after the request's synchronise adds each
    span's milliseconds to ``ms[name]``. Each span is also a profiler
    range, ``bm.<name>``, so that a traced run can sum the device time of
    what was launched inside it. Disabled (``on=False``) or on the CPU it
    records nothing."""

    def __init__(self, device: torch.device, on: bool):
        self.on = on and device.type == "cuda"
        self.ms: dict[str, list[float]] = {}
        self._open: list = []
        self._range = None

    def mark(self, name: str) -> None:
        if not self.on:
            return
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self._open.append((name, ev))
        if name:
            self._range = record_function(RANGE + name)
            self._range.__enter__()

    def close(self) -> None:
        self.mark("")

    def read(self) -> None:
        if not self.on:
            return
        for (name, a), (_, b) in zip(self._open, self._open[1:]):
            self.ms.setdefault(name, []).append(a.elapsed_time(b))
        self._open = []


class Reservoir:
    """A uniform sample of ``k`` of the window's requests (Algorithm R),
    drawn from a seeded NumPy generator: the outputs the check judges."""

    def __init__(self, k: int, rng):
        self.k = k
        self.rng = rng
        self.items: list = []

    def offer(self, n: int, item) -> None:
        """Request ``n`` (0-based, in completion order) with its outputs."""
        if n < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, n + 1))
            if j < self.k:
                self.items[j] = item


def closed_loop(request, seconds: float, device: torch.device, keep,
                tracer=None, trace_requests: int = 0) -> dict:
    """One caller, one request at a time, for ``seconds`` of the host clock.

    ``request(n)`` issues request n and returns (work, failed, outputs);
    the loop synchronises after it, so each latency runs from the request's
    start to its results on the host. The window ends with the first
    request that completes at or after ``seconds``: every request started
    is completed and counted, and the window's length is the time to that
    completion. With a ``tracer``, the profiler covers the first
    ``trace_requests`` requests.
    """
    lat, work, failed = [], 0, 0
    n = 0
    if tracer is not None:
        tracer.start()
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        w, bad, out = request(n)
        sync(device)
        te = time.perf_counter()
        if tracer is not None and n + 1 == trace_requests:
            tracer.stop(n + 1)
        lat.append(te - ts)
        work += w
        failed += int(bad)
        keep.offer(n, out)
        n += 1
        if te - t0 >= seconds:
            break
    if tracer is not None and tracer.active:
        tracer.stop(n)
    return {"seconds": te - t0, "requests": n, "work": work,
            "failed": failed, "latencies_s": lat}
