"""Where the headline query's time goes on the card, by torch.profiler.

Run ``python -m tracer_torch.bench.profile`` on a CUDA machine. For the
whole query, for each stage (prep, phase A, leaf walk), for the shadow
query at the headline size, for the differentiable extra (the checked
soft evaluation, fwd+bwd) and for one step of ``cli fit`` at its full size
(800x600, 20 spheres; ``fit_scene`` with one step, its set-up included) it
profiles ``ITERS`` back-to-back calls and prints, per call: the window's time on CUDA events, the summed device time
of its kernels and copies, the device's idle share of the window, the
number of device launches, and the kernels that take the most device time.
The last line is one JSON object with those numbers. Exits non-zero
without a CUDA device.
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
WARMUP = 3
TOP = 8


def profile_calls(fn, *args, iters: int = ITERS, names=()) -> dict:
    """Device time, idle share and launches per call of ``fn(*args)``,
    after WARMUP calls; with ``names``, also the share of the window spent
    in the kernels whose name contains each of them (``shares``)."""
    for _ in range(WARMUP):
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
    window_ms = start.elapsed_time(end) / iters
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3 / iters
    top = sorted(device, key=lambda e: e.self_device_time_total,
                 reverse=True)[:TOP]
    shares = {n: sum(e.self_device_time_total for e in device
                     if n in e.key) / 1e3 / iters / window_ms
              for n in names}
    return {
        "window_ms": window_ms,
        "device_ms": busy_ms if device else None,
        "idle_share": 1.0 - busy_ms / window_ms if device else None,
        "launches": sum(e.count for e in device) / iters if device else None,
        "shares": shares if device else None,
        "top": [[e.key[:60], e.self_device_time_total / 1e3 / iters,
                 e.count / iters] for e in top],
    }


def describe(name: str, r: dict) -> str:
    """A stage's profile as lines of text: window, device time, idle share
    and launches per call, then its top kernels."""
    busy = ("not measured" if r["device_ms"] is None else
            f"device {r['device_ms']:.3f} ms, idle {r['idle_share']:.3f}, "
            f"{r['launches']:.0f} launches")
    return "\n".join([f"{name}: window {r['window_ms']:.3f} ms; {busy}"]
                     + [f"    {ms:9.4f} ms  x{count:<5g} {key}"
                        for key, ms, count in r["top"]])


def diff_stages(scene, o, d) -> dict:
    """The differentiable extra's checked soft evaluation (fwd+bwd) as a
    stage, over its own inflated-radius tables."""
    return {"diff_fwd_bwd": (headline.diff_fwd_bwd, scene,
                             headline.diff_tables(scene), o, d)}


def fit_stage(device) -> tuple:
    """One step of ``cli fit`` at its defaults, as a stage."""
    from tracer_torch import cli
    from tracer_torch.diff.fit import fit_scene
    args = cli.build_parser().parse_args(["fit"])
    cfg, cam, soft, target, init = cli.fit_problem(args, device)
    return (lambda: fit_scene(target, init, cam, steps=1, lr=args.lr,
                              soft=soft, config=cfg),)


def main() -> int:
    if not torch.cuda.is_available():
        print("tracer_torch.bench.profile needs a CUDA device",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    scene, tables, o, d, _ = headline.benchmark_inputs(dev)
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
        "shadow": (headline.shadow_query, o, d, tables),
        **diff_stages(scene, o, d),
        "fit_step": fit_stage(dev),
    }
    out = {"device": torch.cuda.get_device_name(0)}
    for name, (fn, *args) in stages.items():
        out[name] = r = profile_calls(fn, *args)
        print(describe(name, r))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
