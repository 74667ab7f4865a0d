"""The harness on the CPU: files found by name, a new cell run from new
files alone, the result line, the metrics' arithmetic, every driver and the
reference end to end with the port's plain kernels, and the check failing
on broken outputs and on the control."""

from __future__ import annotations

import json
import statistics

import pytest
import torch

from benchmark.harness import HERE, Bench, judge, load
from benchmark.tests import tiny

MANIFEST = HERE.parent / "BENCHMARK.json"
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("bm"))


def test_manifest_names_files_that_exist():
    b = Bench(MANIFEST)
    m = b.manifest
    for c in m["configs"]:
        assert (HERE.parent / c["file"]).is_file()
        assert b.config(c["name"])["reduced"] == c["reduced"]
    for w in m["workloads"]:
        b.config(w["config"])
        kind = b.traffic(w["traffic"])["kind"]
        assert hasattr(b.driver(kind), "request")
        assert b.limits(w["name"])
        assert b.end_to_end(w["name"]) and b.per_layer(w["name"])
    for metric in m["end_to_end"] + m["per_layer"]:
        assert callable(b.reader(metric["name"]))


def test_a_cell_added_as_files_runs(bench):
    # The tiny cells exist only as new files beside a copy of the
    # benchmark's own, under names the manifest gives.
    assert not (HERE / "configs" / "tiny.json").exists()
    line = tiny.run(bench, "tiny_query")
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"query_mrays_per_s.100k", "setup_s"}


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(bench, trace):
    line = tiny.run(bench, "tiny_query", trace=trace)
    keys = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == keys
    json.loads(json.dumps(line))
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(line["metrics"]) <= {m["name"] for m in
                                        bench.per_layer("tiny_query")}


def _record(latencies, work, seconds):
    return {"setup_s": 1.0, "spans": {},
            "window": {"seconds": seconds, "requests": len(latencies),
                       "work": work, "failed": 0, "latencies_s": latencies}}


def test_rates_take_all_work_over_all_window_time():
    b = Bench(MANIFEST)
    lat = [0.1] * 99 + [2.0]
    rec = _record(lat, work=524288 * 100, seconds=12.0)
    assert b.reader("query_mrays_per_s.100k")(rec) == pytest.approx(
        524288 * 100 / 12.0 / 1e6)
    assert b.reader("frame_ms")(rec) == pytest.approx(120.0)
    # The 95th percentile of all 100 frames, not of a subset.
    p95 = statistics.quantiles(lat, n=20, method="inclusive")[18] * 1e3
    assert b.reader("frame_ms_p95")(rec) == pytest.approx(p95)
    assert b.reader("frame_ms_p95")(_record(lat[:50], 50, 6.0)) == \
        pytest.approx(100.0)


def test_readers_return_nothing_without_a_device_trace():
    b = Bench(MANIFEST)
    rec = _record([0.1], 1, 0.1) | {"device": {
        "busy_s": 0.0, "window_s": 0.1, "launches": 0, "requests": 1,
        "ops": {}}}
    for m in b.manifest["per_layer"]:
        if m["source"] == "device_trace":
            assert b.reader(m["name"])(rec) is None


def test_device_time_is_summed_by_the_span_it_was_launched_in():
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    from benchmark.profiling import WINDOW, by_range
    from benchmark.readers import range_device_ms

    def ev(name, s, e, kernels=()):
        return NS(name=name, device_type=DeviceType.CPU,
                  time_range=NS(start=s, end=e),
                  kernels=[NS(name=k, duration=d) for k, d in kernels])
    events = [
        ev(WINDOW, 0, 100), ev("bm.prep", 1, 10, [("bm.prep", 9.0)]),
        ev("aten::sort", 2, 4, [("sort_kernel", 1.0)]),
        # a kernel launched by the span itself (a library's own launch)
        ev("bm.nearest", 10, 30, [("walk_kernel<16>", 10.0)]),
        ev("aten::mul", 11, 12, [("mul_kernel", 2.0)]),
        ev("aten::add", 40, 41, [("add_kernel", 3.0)]),
        NS(name="mul_kernel", device_type=DeviceType.CUDA,
           time_range=NS(start=32, end=34), kernels=[])]
    ranges = by_range(events, marks={"bm.prep", "bm.nearest"})
    assert ranges == {"prep": {"sort_kernel": [1e-6, 1]},
                      "nearest": {"walk_kernel<16>": [1e-5, 1],
                                  "mul_kernel": [2e-6, 1]}}
    rec = {"device": {"requests": 2, "busy_s": 1.0, "ranges": ranges}}
    assert range_device_ms(rec, "nearest", without=("walk_kernel",)) == \
        pytest.approx(1e-3)
    assert range_device_ms(rec, "prep") == pytest.approx(5e-4)
    assert range_device_ms(rec, "nearest", without=("mul", "walk")) is None


def test_judge_fails_a_number_over_its_limit_or_missing():
    assert judge({"a": 0.0, "b": 1e-6}, {"a": 0, "b": 1e-5})[0]
    assert not judge({"a": 1e-4}, {"a": 1e-5})[0]
    assert not judge({}, {"a": 1.0})[0]


@pytest.mark.parametrize("cell", list(tiny.CELLS))
def test_driver_and_reference_end_to_end(bench, cell):
    line = tiny.run(bench, cell, seed=2 ** 31 + 11)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0


def _answer_altered(monkeypatch, cell):
    """Break the timed path where it produces its answer."""
    if cell in ("tiny_query", "tiny_routed"):
        from tracer_torch.kernels import conecull, tlas
        mod, fn = ((conecull, "nearest_hit_hybrid_feats")
                   if cell == "tiny_query" else
                   (tlas, "nearest_hit_tlas_feats"))
        real = getattr(mod, fn)

        def broken(*a, **k):
            t, slot, ovf = real(*a, **k)
            return t * 1.001, slot, ovf
        monkeypatch.setattr(mod, fn, broken)
    else:
        from tracer_torch.integrator import wavefront
        real = wavefront.render
        monkeypatch.setattr(wavefront, "render",
                            lambda *a, **k: real(*a, **k) * 0.99)


def _half_left_out(monkeypatch, cell):
    """Answer only the first half of each batch."""
    if cell in ("tiny_query", "tiny_routed"):
        from tracer_torch.kernels import conecull, tlas
        mod, fn = ((conecull, "nearest_hit_hybrid_feats")
                   if cell == "tiny_query" else
                   (tlas, "nearest_hit_tlas_feats"))
        real = getattr(mod, fn)

        def broken(*a, **k):
            t, slot, ovf = real(*a, **k)
            h = t.shape[0] // 2
            t, slot = t.clone(), slot.clone()
            t[h:], slot[h:] = torch.inf, -1
            return t, slot, ovf
        monkeypatch.setattr(mod, fn, broken)
    else:
        from tracer_torch.integrator import wavefront
        real = wavefront.render

        def broken(*a, **k):
            img = real(*a, **k).clone()
            img[img.shape[0] // 2:] = 0.0
            return img
        monkeypatch.setattr(wavefront, "render", broken)


@pytest.mark.parametrize("fault", [_answer_altered, _half_left_out],
                         ids=["answer_altered", "half_left_out"])
@pytest.mark.parametrize("cell", list(tiny.CELLS))
def test_check_fails_a_broken_timed_path(bench, monkeypatch, cell, fault):
    fault(monkeypatch, cell)
    line = tiny.run(bench, cell)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", list(tiny.CELLS))
def test_control_in_bfloat16_fails(bench, cell):
    line = tiny.run(bench, cell, control="bfloat16")
    assert not line["correct"], line["checks"]


def test_limits_sit_between_their_readings():
    """Every limit of a manifest cell is recorded with the readings it was
    set from: above the sound runs' largest, below the control's least."""
    b = Bench(MANIFEST)
    for w in b.manifest["workloads"]:
        readings = load(HERE / "limits" / "readings" / f"{w['name']}.json")
        for name, limit in b.limits(w["name"]).items():
            r = readings[name]
            assert r["sound_max"] <= limit, (w["name"], name)
            if r.get("control_min") is not None:
                assert limit < r["control_min"], (w["name"], name)
