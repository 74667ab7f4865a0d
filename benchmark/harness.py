"""Finds everything by name and runs one cell once.

``BENCHMARK.json`` at the root of the checkout names the cells; a cell's
configuration is ``configs/<config>.json``, its traffic
``traffic/<traffic>.json`` (whose ``kind`` picks ``drivers/<kind>.py``),
the limits of its check ``limits/<cell>.json``, and every metric it reports
is read by ``metrics/<metric>.py``. Adding a cell, a configuration, a
traffic mix or a metric adds files and entries; no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

import torch

from benchmark import inputs
from benchmark.timing import Reservoir, Spans, closed_loop, sync

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tracer")


def load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Bench:
    """The manifest and the files it names, under ``root`` (the
    benchmark's folder)."""

    def __init__(self, manifest: Path, root: Path = HERE):
        self.manifest = load(manifest)
        self.root = root

    def cell(self, name: str) -> dict:
        for w in self.manifest["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in the manifest")

    def config(self, name: str) -> dict:
        return load(self.root / "configs" / f"{name}.json")

    def traffic(self, name: str) -> dict:
        return load(self.root / "traffic" / f"{name}.json")

    def limits(self, cell: str) -> dict:
        return load(self.root / "limits" / f"{cell}.json")

    def driver(self, kind: str):
        return importlib.import_module(f"benchmark.drivers.{kind}")

    def reader(self, metric: str):
        """``metrics/<metric>.py``, else ``metrics/<base>.py`` for a metric
        ``<base>.<cells>`` that one reader serves in several cells."""
        path = self.root / "metrics" / f"{metric}.py"
        if not path.is_file():
            path = self.root / "metrics" / f"{metric.split('.')[0]}.py"
        spec = importlib.util.spec_from_file_location(
            f"benchmark_metrics.{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def end_to_end(self, cell: str) -> list[dict]:
        return [m for m in self.manifest["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]

    def per_layer(self, cell: str) -> list[dict]:
        moved = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.manifest["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in moved)]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def device_record(device: torch.device) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": 1,
                "memory_peak_bytes": int(
                    torch.cuda.max_memory_allocated(device))}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit; correct when none is over.
    A limit that has no reading, or whose reading is not a number, fails."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        value = readings.get(name)
        good = value is not None and value == value and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def build(cfg: dict, device: torch.device) -> float:
    """Build (on a checkout's first run) or load the port's native
    libraries that the cell uses: the CUDA kernels and the SAH builder.
    Returns the seconds, which are part of set-up."""
    t0 = time.perf_counter()
    if cfg["bvh"]["builder"] == "native_sah":
        from tracer_torch.bvh import native
        native.load()
    if device.type == "cuda":
        from tracer_torch.kernels import _lib
        _lib.load()
    return time.perf_counter() - t0


def run_cell(bench: Bench, name: str, seed: int, seconds: float,
             trace: bool, device: torch.device, t_start: float,
             control: str | None = None, log=print) -> dict:
    """Set up, warm up, measure, check; returns the result line."""
    wl = bench.cell(name)
    cfg = bench.config(wl["config"])
    tr = bench.traffic(wl["traffic"])
    drv = bench.driver(tr["kind"])
    t0 = time.perf_counter()
    compile_s = build(cfg, device)
    t1 = time.perf_counter()
    st = drv.setup(cfg, tr, seed, device)
    t2 = time.perf_counter()
    drv.warmup(st)
    setup_s = time.perf_counter() - t_start
    log(f"{name}: set-up {setup_s:.3f} s (start and imports {t0 - t_start:.3f}"
        f", compile_s {compile_s:.3f}, inputs and tables {t2 - t1:.3f}, "
        f"warm-up {t_start + setup_s - t2:.3f})")

    spans = Spans(device, on=trace)
    tracer = None
    if trace:
        from benchmark.profiling import Tracer
        tracer = Tracer(device)
        tracer.warm(drv.request(st, Spans(device, on=False)))
    keep = Reservoir(int(tr["check_requests"]), inputs.numpy_rng(seed, 5))
    window = closed_loop(drv.request(st, spans), seconds, device, keep,
                         tracer, int(tr.get("trace_requests", 0)))
    dev = device_record(device)
    log(f"{name}: {window['requests']} requests in {window['seconds']:.3f}"
        f" s, {window['failed']} failed")
    record = {"setup_s": setup_s, "window": window, "spans": spans.ms,
              "traffic": tr, "config": cfg}
    breakdown = None
    if tracer is not None:
        record["device"] = tr_sum = tracer.summary()
        dev["busy_s"] = tr_sum["busy_s"]
        dev["window_s"] = tr_sum["window_s"]
        breakdown = {"device_ops": tr_sum["device_ops"],
                     "idle_gaps": tr_sum["idle_gaps"]}
        del tracer
    kept = drv.release(st, keep.items)
    del keep
    t_check = time.perf_counter()
    readings = drv.check(st, kept, control)
    log(f"{name}: check {time.perf_counter() - t_check:.3f} s")
    ok, checks = judge(readings, bench.limits(name))
    log(f"{name}: readings {readings}")

    metrics = {}
    wanted = bench.per_layer(name) if trace else bench.end_to_end(name)
    for m in wanted:
        value = bench.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if trace:
        log(f"{name}: spans (ms, median) " + ", ".join(
            f"{k} {statistics.median(v):.4f}" for k, v in spans.ms.items()))
    line = {"correct": ok, "attempted": window["requests"],
            "failed": window["failed"], "metrics": metrics, "device": dev}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return line
