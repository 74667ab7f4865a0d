"""The per-layer metrics that read the program's own trace
(``tracer_torch.trace``), on the CPU: each tiny cell run traced reports
every one of them as a number, its check still passes, and the per-layer
metrics read from the profiler are still reported beside them.

On the CPU the profiler sees no device operation and the caching
allocator does not exist, so two card readings are stood in for: the
profile's device part (operations by kernel group, busy time, the
closest-hit span's operations) is added to the CPU profile, and the
allocator's count of device allocations is a counter that steps by one a
reading."""

from __future__ import annotations

import itertools

import pytest
import torch

from benchmark.harness import HERE, Bench
from benchmark.profiling import Tracer
from benchmark.tests import tiny

MANIFEST = HERE.parent / "BENCHMARK.json"
# The metrics that read the program's trace, by the file that reads them.
NEW = ("prep_host_ms", "phase_a_host_ms", "group_row_share", "pair_fill",
       "render_host_ms", "live_ray_share", "resumed_packet_share",
       "packet_steps", "device_allocs")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("bm"))


def _card_profile(monkeypatch):
    real = Tracer.summary

    def summary(self):
        s = real(self)
        s["busy_s"] = s["window_s"] / 2
        s["ops"] = {"leafwalk::walk_items<ClosestWalk<GridRows>>": [2e-3, 1],
                    "walk_kernel<16>": [2e-3, 1], "compact_rows": [1e-4, 2]}
        s["ranges"] = {"nearest": {"compact_rows": [1e-4, 2],
                                   "elementwise_kernel": [1e-3, 9]}}
        return s
    monkeypatch.setattr(Tracer, "summary", summary)


def _allocator(monkeypatch):
    from tracer_torch import trace
    step = itertools.count()
    monkeypatch.setattr(trace, "_allocs", lambda: next(step))


@pytest.mark.parametrize("cell", list(tiny.CELLS))
def test_new_metrics_are_numbers_beside_the_old(bench, monkeypatch, cell):
    from tracer_torch import trace
    _card_profile(monkeypatch)
    _allocator(monkeypatch)
    trace.reset()
    line = tiny.run(bench, cell, seed=2 ** 31 + 3, trace=True)
    assert line["correct"], line["checks"]
    wanted = bench.per_layer(cell)
    new = {m["name"] for m in wanted if m["name"].split(".")[0] in NEW}
    assert new, cell
    for name in new:
        value = line["metrics"].get(name, {}).get("value")
        assert isinstance(value, float) and value == value, (name, value)
    # Every profiler metric of the cell but prep_ms, a CUDA-event span
    # that only a card takes, is still reported.
    old = {m["name"] for m in wanted if m["name"] not in new
           and m["source"] == "device_trace"}
    assert old and old <= set(line["metrics"]), old - set(line["metrics"])


def test_shares_lie_in_their_range(bench):
    from tracer_torch import trace
    trace.reset()
    fr = tiny.run(bench, "tiny_path", trace=True)["metrics"]
    for name in ("live_ray_share.frame", "resumed_packet_share.frame"):
        assert 0.0 <= fr[name]["value"] <= 1.0, name
    assert fr["packet_steps.frame"]["value"] >= 1.0
    trace.reset()
    q = tiny.run(bench, "tiny_routed", trace=True)["metrics"]
    assert 0.0 < q["pair_fill.query_10m"]["value"] <= 1.0
    assert 0.0 <= q["group_row_share.query_10m"]["value"] <= 1.0


def test_readers_return_nothing_without_the_program_trace(monkeypatch):
    """A program without ``tracer_torch.trace``, as a parent commit may
    be: every new reader returns None and raises nothing."""
    import sys

    import tracer_torch
    b = Bench(MANIFEST)
    monkeypatch.setitem(sys.modules, "tracer_torch.trace", None)
    monkeypatch.delattr(tracer_torch, "trace")
    rec = {"setup_s": 1.0, "spans": {},
           "window": {"seconds": 1.0, "requests": 1, "work": 1,
                      "failed": 0, "latencies_s": [1.0]}}
    names = [m["name"] for m in b.manifest["per_layer"]
             if m["name"].split(".")[0] in NEW]
    assert len(names) == 14
    for name in names:
        assert b.reader(name)(rec) is None, name
