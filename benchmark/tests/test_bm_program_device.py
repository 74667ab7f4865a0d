"""The per-layer metrics that read the program's own device counters
(``benchmark/program_device.py``: host syncs and their waits, the device
time of the port's kernels by span), on the CPU.

Each tiny cell, run traced, reports every one of them that its real cell
lists as a number. The CPU launches none of the port's kernels, so the
card's counters are stood in for: each span of a layer that launches them
on the card (prep, phase A, the compactor, the walks, the soft composite
and backward) gets ``kernels`` and ``kernel_ns`` as ``trace.records``
hands it out. The host syncs are the CPU's own: every root carries
``syncs``, and the ``sync`` spans are there. Without the program's trace,
or without its counters (a program that predates them), every reader
returns None and raises nothing."""

from __future__ import annotations

import sys

import pytest
import torch

from benchmark.harness import HERE, Bench, load
from benchmark.tests import tiny

MANIFEST = HERE.parent / "BENCHMARK.json"
READERS = ("host_wait_ms", "host_syncs", "walk_kernel_ms",
           "anyhit_kernel_ms", "soft_kernel_ms")
# The spans that launch the port's kernels on the card.
LAUNCHING = ("prep", "phase_a", "compact", "walk", "composite", "backward")
KERNEL_NS = 125_000
# real cell -> the tiny cell that reports what it reports
COPIES = {"query_100k": "tiny_query", "query_10m": "tiny_routed",
          "path_100k_packets": "tiny_path", "direct_100k": "tiny_direct",
          "grad_100k": "tiny_grad"}
# The tiny direct cell takes the leaf walks' plain versions (the CPU's
# --impl auto takes the dense oracles); the tiny grad cell is
# test_bm_grad.py's.
DIRECT = {"impl": "leafcull"}
GRAD = {"rays": 1024, "pool": 2, "cell_bits": 4, "max_leaves": 2,
        "block_bytes": 1 << 24, "warmup_requests": 1, "trace_requests": 2,
        "check_requests": 2}
SEED = 2 ** 31 + 28


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """The tiny benchmark with a tiny direct and a tiny grad cell added as
    files; every per-layer metric that lists a real cell lists its tiny
    copy."""
    tmp = tmp_path_factory.mktemp("bm")
    tiny.make(tmp)
    root = tmp / "benchmark"
    real = load(MANIFEST)
    tiny.write(root / "traffic" / "tiny_direct.json",
               load(HERE / "traffic" / "direct_800x600_auto.json")
               | tiny.TRAFFIC["path_800x600_packets"] | DIRECT)
    tiny.write(root / "configs" / "tiny_direct.json",
               load(HERE / "configs" / "render_direct_100k.json")
               | tiny.CONFIG)
    tiny.write(root / "limits" / "tiny_direct.json",
               load(HERE / "limits" / "direct_100k.json"))
    tiny.write(root / "traffic" / "tiny_grad.json",
               load(HERE / "traffic" / "grad_131k.json") | GRAD)
    tiny.write(root / "configs" / "tiny_grad.json",
               load(HERE / "configs" / "inverse_100k.json")
               | {"spheres": 1000, "world": 215.0})
    tiny.write(root / "limits" / "tiny_grad.json",
               load(HERE / "limits" / "grad_100k.json"))
    manifest = load(tmp / "BENCHMARK.json")
    manifest["workloads"] += [
        {"name": "tiny_direct", "config": "tiny_direct",
         "traffic": "tiny_direct", "chips": 1, "why": "a test"},
        {"name": "tiny_grad", "config": "tiny_grad", "traffic": "tiny_grad",
         "chips": 1, "why": "a test"}]
    for m, r in zip(manifest["end_to_end"] + manifest["per_layer"],
                    real["end_to_end"] + real["per_layer"]):
        if "workloads" in m:
            m["workloads"] = [COPIES[c] for c in r["workloads"]
                              if c in COPIES]
    tiny.write(tmp / "BENCHMARK.json", manifest)
    return Bench(tmp / "BENCHMARK.json", root)


def _card_kernels(monkeypatch):
    from tracer_torch import trace
    real = trace.records

    def records():
        recs = real()
        for r in recs:
            for s in r["spans"]:
                if s["name"][len(trace.PREFIX):] in LAUNCHING:
                    s["counters"].setdefault("kernels", 1)
                    s["counters"].setdefault("kernel_ns", KERNEL_NS)
        return recs
    monkeypatch.setattr(trace, "records", records)


def _new(bench, cell):
    return {m["name"] for m in bench.per_layer(cell)
            if m["name"].split(".")[0] in READERS}


@pytest.mark.parametrize("cell", list(COPIES.values()))
def test_new_readers_are_numbers_on_the_tiny_cells(bench, monkeypatch, cell):
    from tracer_torch import trace
    _card_kernels(monkeypatch)
    trace.reset()
    line = tiny.run(bench, cell, seed=SEED, trace=True)
    assert line["correct"], line["checks"]
    new = _new(bench, cell)
    assert new, cell
    m = {k: v["value"] for k, v in line["metrics"].items()}
    for name in new:
        assert isinstance(m.get(name), float) and m[name] >= 0.0, \
            (name, m.get(name))
    for name in new:
        if "_kernel_ms" in name:
            # A stood-in span's time, a positive multiple of it a request.
            assert m[name] > 0.0 and (m[name] * 1e6 / KERNEL_NS) % 1 == 0, \
                (name, m[name])


def test_the_fifteen_entries():
    b = Bench(MANIFEST)
    new = [m for m in b.manifest["per_layer"]
           if m["name"].split(".")[0] in READERS]
    assert len(new) == 15
    cells = {m["name"]: m["workloads"] for m in new}
    host = ["query_100k", "path_100k", "direct_100k", "grad_100k"]
    for base in ("host_wait_ms", "host_syncs"):
        assert [c for n, (c,) in cells.items()
                if n.startswith(base + ".")] == host
    assert cells["walk_kernel_ms.frame"] == ["path_100k_packets"]
    for m in new:
        moved = {e["name"] for e in b.end_to_end(m["workloads"][0])}
        assert m["moves"] in moved and m["moves"] != "setup_s", m["name"]
        assert m["source"] == ("program_span" if m["name"].startswith(
            "host_wait_ms") else "program_counter")


def _strip(monkeypatch):
    """The trace as a program without the new counters keeps it."""
    from tracer_torch import trace
    real = trace.records

    def records():
        recs = real()
        for r in recs:
            for s in r["spans"]:
                for k in ("syncs", "kernels", "kernel_ns"):
                    s["counters"].pop(k, None)
        return recs
    monkeypatch.setattr(trace, "records", records)


@pytest.mark.parametrize("missing", ["module", "counters"])
def test_readers_return_nothing_without_the_counters(bench, monkeypatch,
                                                     missing):
    from tracer_torch import trace
    trace.reset()
    tiny.run(bench, "tiny_query", seed=SEED, trace=True)
    assert trace.records()
    if missing == "module":
        import tracer_torch
        monkeypatch.setitem(sys.modules, "tracer_torch.trace", None)
        monkeypatch.delattr(tracer_torch, "trace")
    else:
        _strip(monkeypatch)
    rec = {"setup_s": 1.0, "spans": {},
           "window": {"seconds": 1.0, "requests": 1, "work": 1,
                      "failed": 0, "latencies_s": [1.0]}}
    b = Bench(MANIFEST)
    for name in [m["name"] for m in b.manifest["per_layer"]
                 if m["name"].split(".")[0] in READERS]:
        assert b.reader(name)(rec) is None, name


def test_kernel_time_goes_to_the_span_that_launched_it(monkeypatch):
    """A frame with a closest-hit and a shadow call: the walks' time is
    both walks', the any-hit time only the walk inside ``occluded``, a
    compaction inside phase A counts as the compactor's, not phase A's;
    the host wait is the ``sync`` spans' host time; the syncs are every
    span's."""
    from benchmark import program_device as pd
    from tracer_torch import trace

    def span(i, name, parent, counters, ms=1.0):
        return {"name": "tracer_torch." + name, "id": i, "parent": parent,
                "start_ns": 0, "end_ns": int(ms * 1e6),
                "counters": counters}
    spans = [span(0, "render", None, {"syncs": 1}),
             span(1, "nearest", 0, {}),
             span(2, "phase_a", 1, {"kernels": 1, "kernel_ns": 1_000}),
             span(3, "compact", 2, {"kernels": 2, "kernel_ns": 20_000}),
             span(4, "walk", 1, {"kernels": 1, "kernel_ns": 300_000}),
             span(5, "sync", 1, {"syncs": 1}, ms=0.5),
             span(6, "occluded", 0, {}),
             span(7, "walk", 6, {"kernels": 1, "kernel_ns": 4_000_000}),
             span(8, "sync", 6, {"syncs": 2}, ms=0.25)]
    root = dict(spans[0], spans=spans)
    monkeypatch.setattr(trace, "records", lambda: [root, root])
    assert pd.per_request(pd.kernel_ms(("walk",))) == 4.3
    assert pd.per_request(pd.kernel_ms(("walk",), under="occluded")) == 4.0
    assert pd.per_request(pd.kernel_ms(("phase_a",))) == 0.001
    assert pd.per_request(pd.kernel_ms(("compact",))) == 0.02
    assert pd.per_request(pd.kernel_ms(("prep",))) is None
    assert pd.per_request(pd.wait_ms) == 0.75
    assert pd.per_request(pd.syncs) == 4.0
