"""A benchmark folder of tiny cells, written beside a copy of the real
one, for the CPU tests: every cell a traffic kind of the real benchmark at
a size that runs in seconds on the CPU with the port's plain kernels."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import torch

from benchmark.harness import HERE, Bench, load, run_cell

# 3,000 spheres in a cube of side 310 are as dense as 100,000 in one of
# side 1,000.
CONFIG = {"spheres": 3000, "world": 310.0}
ROUTED = {"spheres": 20000, "world": 200.0,
          "bvh": {"builder": "device_lbvh", "leaf_size": 32}}
TRAFFIC = {
    "query_524k": {"rays": 4096, "check_rays": 512, "trace_requests": 2,
                   "check_requests": 2, "warmup_requests": 1},
    "query_131k": {"rays": 4096, "check_rays": 256, "trace_requests": 2,
                   "check_requests": 2, "warmup_requests": 1},
    "path_800x600_packets": {"width": 64, "height": 48,
                             "check_pixels": 512, "trace_requests": 2,
                             "check_requests": 2, "warmup_requests": 1,
                             "path_frames": 10},
}
# name -> (config, traffic, limits)
CELLS = {
    "tiny_query": ("tiny", "tiny_query_524k",
                   {"id_mismatch_share": 1e-3, "t_rel_err_max": 1e-4}),
    "tiny_routed": ("tiny_routed", "tiny_query_131k",
                    {"id_mismatch_share": 1e-3, "t_rel_err_max": 1e-4}),
    "tiny_path": ("tiny", "tiny_path_800x600_packets",
                  {"pixel_mismatch_share": 1e-2}),
}
# Each tiny cell reports the end-to-end metrics of the real cell it copies.
COPIES = {"tiny_query": "query_100k", "tiny_routed": "query_10m",
       "tiny_path": "path_100k_packets"}


def write(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1))


def make(tmp: Path) -> Bench:
    """A copy of the benchmark's data files under ``tmp/benchmark`` with the
    tiny cells added as new files, and a manifest of the tiny cells."""
    root = tmp / "benchmark"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(HERE / sub, root / sub)
    base = load(HERE / "configs" / "spheres_100k.json")
    write(root / "configs" / "tiny.json", base | CONFIG)
    write(root / "configs" / "tiny_routed.json", base | ROUTED)
    for name, over in TRAFFIC.items():
        write(root / "traffic" / f"tiny_{name}.json",
              load(HERE / "traffic" / f"{name}.json") | over)
    for name, (_, _, limits) in CELLS.items():
        write(root / "limits" / f"{name}.json", limits)
    manifest = load(HERE.parent / "BENCHMARK.json")
    manifest["workloads"] = [
        {"name": n, "config": c, "traffic": t, "chips": 1, "why": "a test"}
        for n, (c, t, _) in CELLS.items()]
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [n for n, real in COPIES.items()
                              if real in m["workloads"]]
    write(tmp / "BENCHMARK.json", manifest)
    return Bench(tmp / "BENCHMARK.json", root)


def run(bench: Bench, cell: str, seed: int = 5, trace: bool = False,
        control=None, seconds: float = 0.2) -> dict:
    return run_cell(bench, cell, seed, seconds, trace, torch.device("cpu"),
                    time.perf_counter(), control=control,
                    log=lambda *a: None)
