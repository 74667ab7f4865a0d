"""Device timing on the card with CUDA events.

PyTorch counterpart of ``tracer/bench/timing.py``. A CUDA stream runs its
work in order and PyTorch neither caches nor drops a call, so no chained
carry is needed: warm up, synchronize, record an event, run ``iters`` calls,
record a second event, synchronize, and divide the elapsed time. Outputs
never feed back into inputs, so a miss (t = +inf) cannot poison later calls.
"""

from __future__ import annotations

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
