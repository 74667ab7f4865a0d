"""The traced run's device record, from ``torch.profiler``.

The profiler (CPU and CUDA activity, CUPTI on the card) covers the first
requests of the window inside one ``record_function`` range, ``bm.window``.
From its events this module takes, over that range: the device operations
(kernels, copies, sets) with their times, their union (the seconds in which
an operation ran on the device), the launches, the operations that took the
most time, and the longest gaps between device operations, each named by
the innermost host operation running at its middle. Grouping by kernel
name follows ``tracer_torch.bench.profile.profile_calls``, which sums
``key_averages()`` by name over a CUDA-event window.
"""

from __future__ import annotations

import bisect
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark.timing import RANGE

WINDOW = "bm.window"
TOP = 10


class Tracer:
    def __init__(self, device: torch.device):
        self.device = device
        self.active = False
        self.requests = 0
        self._prof = None

    def warm(self, request) -> None:
        """One request under a profiler of its own, before the window:
        the profiler's first start (CUPTI's set-up) stays out of it."""
        with profile(activities=self._activities()):
            request(0)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def _activities(self):
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return acts

    def start(self) -> None:
        self._prof = profile(activities=self._activities())
        self._prof.__enter__()
        self._range = record_function(WINDOW)
        self._range.__enter__()
        self.active = True
        self.t0 = time.perf_counter()

    def stop(self, requests: int) -> None:
        """End the traced range after ``requests`` requests, all of them
        synchronised."""
        self._range.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.host_s = time.perf_counter() - self.t0
        self.active = False
        self.requests = requests

    def summary(self) -> dict:
        """busy_s, window_s, launches, ops {name: [seconds, count]},
        ranges (:func:`by_range`), device_ops and idle_gaps (at most TOP
        each, [name, seconds]), requests: all over the traced range."""
        events = list(self._prof.events())
        marks = {e.name for e in events
                 if getattr(e, "is_user_annotation", False)} | {WINDOW}
        win = [e for e in events if e.name == WINDOW
               and e.device_type == DeviceType.CPU]
        if win:
            ws, we = win[0].time_range.start, win[0].time_range.end
        else:
            ws, we = 0.0, self.host_s * 1e6
        dev = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in events
                     if e.device_type == DeviceType.CUDA
                     and e.name not in marks
                     and e.time_range.end > ws and e.time_range.start < we)
        host = [(e.time_range.start, e.time_range.end, e.name)
                for e in events
                if e.device_type == DeviceType.CPU and e.name not in marks]
        ops: dict[str, list] = {}
        for s, e, name in dev:
            rec = ops.setdefault(name, [0.0, 0])
            rec[0] += (e - s) / 1e6
            rec[1] += 1
        segs: list[list[float]] = []
        for s, e, _ in dev:
            s, e = max(s, ws), min(e, we)
            if segs and s <= segs[-1][1]:
                segs[-1][1] = max(segs[-1][1], e)
            else:
                segs.append([s, e])
        busy = sum(e - s for s, e in segs) / 1e6
        edges = [ws] + [x for seg in segs for x in seg] + [we]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                       for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:TOP]
        top = sorted(ops.items(), key=lambda kv: kv[1][0], reverse=True)
        return {
            "ranges": by_range(events, marks),
            "busy_s": busy,
            "window_s": (we - ws) / 1e6,
            "launches": len(dev),
            "requests": self.requests,
            "ops": ops,
            "device_ops": [[name[:160], rec[0]] for name, rec in top[:TOP]],
            "idle_gaps": [[host_at(host, start + length / 2), length / 1e6]
                          for length, start in gaps],
        }


def by_range(events, marks=frozenset()) -> dict:
    """{span: {op name: [seconds, count]}}: the device operations of the
    traced range by the span (``timing.Spans``, a ``bm.<span>`` range on
    the host) in which they were launched. The profiler hands each device
    operation to the innermost host operation that launched it (its
    ``kernels``); an operation whose host operation starts outside every
    span is left out, and so are the spans' own device annotations."""
    spans = sorted((e.time_range.start, e.time_range.end,
                    e.name[len(RANGE):]) for e in events
                   if e.device_type == DeviceType.CPU
                   and e.name.startswith(RANGE) and e.name != WINDOW)
    starts = [s for s, _, _ in spans]
    out: dict[str, dict] = {}
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        t = e.time_range.start
        i = bisect.bisect_right(starts, t) - 1
        if i < 0 or t > spans[i][1]:
            continue
        for k in e.kernels:
            if k.name in marks:
                continue
            rec = out.setdefault(spans[i][2], {}).setdefault(k.name,
                                                             [0.0, 0])
            rec[0] += k.duration / 1e6
            rec[1] += 1
    return out


def host_at(host, t: float) -> str:
    """The innermost host operation running at time ``t`` (us)."""
    best = None
    for s, e, name in host:
        if s <= t <= e and (best is None or e - s < best[0]):
            best = (e - s, name)
    return "host: no profiled operation" if best is None else best[1][:160]
