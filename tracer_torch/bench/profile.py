"""Where the headline query's time goes on the card, by torch.profiler.

Run ``python -m tracer_torch.bench.profile`` on a CUDA machine. For the
whole query and for each stage (prep, phase A, leaf walk) at the headline
size it profiles ``ITERS`` back-to-back calls and prints, per call: the
window's time on CUDA events, the summed device time of its kernels and
copies, the device's idle share of the window, the number of device
launches, and the kernels that take the most device time. The last line is
one JSON object with those numbers. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import sys

import torch
from torch.profiler import ProfilerActivity, profile

from tracer_torch.bench import headline
from tracer_torch.kernels.conecull import cone_candidates
from tracer_torch.kernels.leafcull import leafcull_call

ITERS = 10
TOP = 8


def profile_calls(fn, *args) -> dict:
    """Device time, idle share and launches per call of ``fn(*args)``."""
    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(ITERS):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
    window_ms = start.elapsed_time(end) / ITERS
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3 / ITERS
    top = sorted(device, key=lambda e: e.self_device_time_total,
                 reverse=True)[:TOP]
    return {
        "window_ms": window_ms,
        "device_ms": busy_ms if device else None,
        "idle_share": 1.0 - busy_ms / window_ms if device else None,
        "launches": sum(e.count for e in device) / ITERS if device else None,
        "top": [[e.key[:60], e.self_device_time_total / 1e3 / ITERS,
                 e.count / ITERS] for e in top],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("tracer_torch.bench.profile needs a CUDA device",
              file=sys.stderr)
        return 1
    _, tables, o, d, _ = headline.benchmark_inputs(torch.device("cuda"))
    cull = tables.cull
    feats, _ = headline.prep(o, d)
    rows = cone_candidates(feats, tables, headline.MG, headline.MC)[0]
    rows = rows.reshape(cull.num_chunks, feats.shape[0], headline.S,
                        rows.shape[-1])
    stages = {
        "query": (headline.query, o, d, tables),
        "prep": (headline.prep, o, d),
        "phase_a": (cone_candidates, feats, tables, headline.MG,
                    headline.MC),
        "walk": (leafcull_call, feats, rows, cull.prims, cull.leaf_size,
                 cull.leaves_per_chunk, cull.leaves_per_group),
    }
    out = {"device": torch.cuda.get_device_name(0)}
    for name, (fn, *args) in stages.items():
        out[name] = r = profile_calls(fn, *args)
        busy = ("not measured" if r["device_ms"] is None else
                f"device {r['device_ms']:.3f} ms, idle "
                f"{r['idle_share']:.3f}, {r['launches']:.0f} launches")
        print(f"{name}: window {r['window_ms']:.3f} ms; {busy}")
        for key, ms, count in r["top"]:
            print(f"    {ms:9.4f} ms  x{count:<5g} {key}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
