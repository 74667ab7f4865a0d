"""Where a rendered frame's time goes on the card, by torch.profiler.

Run ``python -m tracer_torch.bench.render`` on a CUDA machine. It renders
the full-size frame of the render slice (100k spheres of the benchmark
distribution in the 1000-unit world, the default camera, 800x600, with
compaction) through ``tracer_torch.cli``'s own code path, in path mode
(depth 5) and direct mode, with ``--impl auto``, ``pallas`` and
``tilecull``. For each it profiles ``ITERS`` frames on one fixed noise
tensor and prints, per frame: the window's time on CUDA events, the device
time, the device's idle share of the window, the device launches, the
share of the window in each hand-written kernel, the checked drivers'
calls and escalations per frame, and the kernels that take the most device
time. The last line is one JSON object with those numbers. Exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import json
import sys

import torch

from tracer_torch import cli
from tracer_torch.bench.profile import WARMUP, profile_calls
from tracer_torch.integrator.wavefront import bounce_noise

ITERS = 5
SPHERES = 100_000
WIDTH, HEIGHT = 800, 600
MODES = ("path", "direct")
IMPLS = ("auto", "pallas", "tilecull")
# Substrings of the hand-written kernels' names; the split walks are
# leafwalk::walk_items<ClosestWalk<GridRows>>, <AnyhitWalk> and
# tilewalk::walk_items<TileWalk>, the packet walk's two launches
# walk_kernel<LS> and resume_kernel<K, LS>.
KERNELS = ("ClosestWalk", "compact_rows", "AnyhitWalk", "walk_kernel",
           "resume_kernel", "TileWalk")


def argv(mode: str, impl: str) -> list[str]:
    """The CLI arguments of one (mode, impl) frame of the render slice."""
    a = ["render", "--scene", "benchmark", "--spheres", str(SPHERES),
         "--world-size", "1000", "--width", str(WIDTH), "--height",
         str(HEIGHT), "--compact", "--mode", mode, "--impl", impl]
    return a + (["--depth", "5"] if mode == "path" else [])


def main() -> int:
    if not torch.cuda.is_available():
        print("tracer_torch.bench.render needs a CUDA device",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    out = {"device": torch.cuda.get_device_name(0)}
    noise = None
    for mode in MODES:
        for impl in IMPLS:
            session = cli.prepare(cli.build_parser().parse_args(
                argv(mode, impl)))
            cfg = session.config
            if noise is None:
                noise = bounce_noise(torch.Generator(device=dev)
                                     .manual_seed(1),
                                     (cfg.height, cfg.width), cfg.max_depth,
                                     dev)
            r = profile_calls(session.frame, session.camera, noise,
                              iters=ITERS, names=KERNELS)
            frames = WARMUP + ITERS
            calls = {k: v / frames for k, v in session.counts.items()}
            r["queries_per_frame"] = calls
            out[f"{mode}/{impl}"] = r
            busy = ("not measured" if r["device_ms"] is None else
                    f"device {r['device_ms']:.3f} ms, idle "
                    f"{r['idle_share']:.3f}, {r['launches']:.0f} launches")
            print(f"{mode}/{impl}: window {r['window_ms']:.3f} ms; {busy}; "
                  f"kernel shares {r['shares']}; per frame {calls}")
            for key, ms, count in r["top"]:
                print(f"    {ms:9.4f} ms  x{count:<5g} {key}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
