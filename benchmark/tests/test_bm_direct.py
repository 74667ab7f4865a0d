"""The direct-lighting cell, ``direct_100k``, on the CPU: a tiny copy of it
(traffic ``direct_800x600_auto`` cut to 64x48, configuration
``render_direct_100k`` cut to the tiny scene) runs through the harness and
passes its check, the bfloat16 control fails it, and the readers it adds
read the program's trace of direct frames.

On the CPU ``--impl auto`` takes the dense closest hit and the dense
shadow oracle at the tiny scene's 3,000 spheres (on the card, above 4,000,
the leaf walk and the any-hit leaf walk), so a second tiny cell renders the
same traffic through ``--impl leafcull``: the plain versions of both walks
behind their escalating drivers, whose spans the new readers read."""

from __future__ import annotations

import pytest
import torch

from benchmark.harness import HERE, Bench, load
from benchmark.tests import tiny

MANIFEST = HERE.parent / "BENCHMARK.json"
CELL = "direct_100k"
CONFIG = "render_direct_100k"
TRAFFIC = "direct_800x600_auto"
# tiny cell -> the traffic's impl
CELLS = {"tiny_direct_auto": "auto", "tiny_direct_leafcull": "leafcull"}
NEW_READERS = ("anyhit_device_ms.direct_100k", "occluded_host_ms.direct_100k",
               "live_ray_share.direct_100k",
               "escalated_ray_share.direct_100k")
PROGRAM_READERS = NEW_READERS[1:]   # the device reader needs the card
SEED = 2 ** 31 + 24


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """The tiny benchmark with the two cells added as files, each
    reporting what ``direct_100k`` reports."""
    tmp = tmp_path_factory.mktemp("bm")
    tiny.make(tmp)
    root = tmp / "benchmark"
    real = load(MANIFEST)
    over = tiny.TRAFFIC["path_800x600_packets"]
    for name, impl in CELLS.items():
        tiny.write(root / "traffic" / f"{name}.json",
                   load(HERE / "traffic" / f"{TRAFFIC}.json") | over
                   | {"impl": impl})
        tiny.write(root / "limits" / f"{name}.json",
                   load(HERE / "limits" / f"{CELL}.json"))
    tiny.write(root / "configs" / "tiny_direct.json",
               load(HERE / "configs" / f"{CONFIG}.json") | tiny.CONFIG)
    manifest = load(tmp / "BENCHMARK.json")
    manifest["workloads"] = [
        {"name": n, "config": "tiny_direct", "traffic": n, "chips": 1,
         "why": "a test"} for n in CELLS]
    for m, r in zip(manifest["end_to_end"] + manifest["per_layer"],
                    real["end_to_end"] + real["per_layer"]):
        if "workloads" in m:
            m["workloads"] = list(CELLS) if CELL in r["workloads"] else []
    tiny.write(tmp / "BENCHMARK.json", manifest)
    return Bench(tmp / "BENCHMARK.json", root)


def test_the_cell_reports_frames_and_its_eight_readings():
    b = Bench(MANIFEST)
    wl = b.cell(CELL)
    assert (wl["config"], wl["traffic"], wl["chips"]) == (CONFIG, TRAFFIC, 1)
    assert b.traffic(TRAFFIC)["kind"] == "direct"
    assert {m["name"] for m in b.end_to_end(CELL)} == {
        "frame_ms", "frame_ms_p95", "setup_s"}
    names = {m["name"] for m in b.per_layer(CELL)}
    assert set(NEW_READERS) <= names and len(names) == 8
    assert all(m["moves"] == "frame_ms" and m["workloads"] == [CELL]
               for m in b.per_layer(CELL))
    assert set(b.limits(CELL)) == {"pixel_mismatch_share"}


def test_the_config_is_the_100k_render_scene_under_a_point_light():
    """``render_direct_100k`` draws ``render_100k``'s spheres from a seed,
    at the same render leaf size, and states the light it assumes."""
    b = Bench(MANIFEST)
    direct, render = b.config(CONFIG), b.config("render_100k")
    scene = ("spheres", "world", "radius", "centers", "albedo", "precision")
    assert {k: direct[k] for k in scene} == {k: render[k] for k in scene}
    assert direct["bvh"] == render["bvh"] | {"shadow_leaf_size": 32}
    assert direct["light"] == {"position": [0.0, 200.0, 0.0],
                               "intensity": 1.0, "ambient": 0.1}
    assert direct["reduced"] == [] and len(direct["assumed"]) == 3
    entries = {c["name"]: c for c in b.manifest["configs"]}
    assert entries[CONFIG]["source"] == direct["source"]
    assert len(direct["source"]) <= 200
    assert "src/benchmark.c:296-314" in direct["source"]


def test_the_driver_passes_the_light_through_the_cli_flags():
    from benchmark.drivers import direct
    from types import SimpleNamespace
    b = Bench(MANIFEST)
    st = SimpleNamespace(cfg=b.config(CONFIG), tr=b.traffic(TRAFFIC),
                         device=torch.device("cpu"))
    args = direct._args(st)
    assert (args.mode, args.impl, args.leaf_size, args.compact) == (
        "direct", "auto", 16, True)
    assert [float(x) for x in args.light.split(",")] == [0.0, 200.0, 0.0]
    assert args.light_intensity == 1.0
    assert (args.width, args.height) == (800, 600)


@pytest.mark.parametrize("cell", list(CELLS))
def test_tiny_cell_runs_and_passes_its_check(bench, cell):
    line = tiny.run(bench, cell, seed=SEED)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"frame_ms", "frame_ms_p95", "setup_s"}


def test_tiny_cell_fails_the_bfloat16_control(bench):
    line = tiny.run(bench, "tiny_direct_auto", seed=SEED, control="bfloat16")
    assert not line["correct"], line["checks"]


def test_new_readers_read_the_leaf_walks_frames(bench):
    from tracer_torch import trace
    trace.reset()
    line = tiny.run(bench, "tiny_direct_leafcull", seed=SEED + 1,
                    trace=True)
    assert line["correct"], line["checks"]
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert m["occluded_host_ms.direct_100k"] > 0.0
    assert 0.0 < m["live_ray_share.direct_100k"] < 1.0
    assert m["escalated_ray_share.direct_100k"] >= 0.0
    assert m["render_host_ms.direct_100k"] > 0.0
    # No device on the CPU: the device readers read nothing.
    assert "anyhit_device_ms.direct_100k" not in m
    assert "walk_device_ms.direct_100k" not in m


def _root(spans):
    """A frame's root as ``trace.records`` gives it."""
    root = {"name": "tracer_torch.render", "counters": {}}
    return root | {"spans": [root] + [{"name": "tracer_torch." + n,
                                       "counters": c} for n, c in spans]}


def test_escalated_ray_share_counts_both_queries(monkeypatch):
    from tracer_torch import trace
    read = Bench(MANIFEST).reader("escalated_ray_share.direct_100k")
    frames = [
        _root([("nearest", {"rays": 1000}), ("shadow", {}),
               ("occluded", {"rays": 1000}),
               ("escalate", {"escalated_rays": 1000})]),
        _root([("nearest", {"rays": 1000}),
               ("escalate", {"escalated_rays": 1000}),
               ("shadow", {}), ("occluded", {"rays": 1000}),
               ("escalate", {"escalated_rays": 1000}),
               ("escalate", {"escalated_rays": 1000})]),
        _root([("nearest", {"rays": 1000}), ("occluded", {"rays": 1000})])]
    monkeypatch.setattr(trace, "records", lambda: frames)
    assert read({}) == pytest.approx(0.5)      # median of 1/2, 3/2, 0
    old = [_root([("nearest", {"rays": 10}), ("escalate", {})])]
    monkeypatch.setattr(trace, "records", lambda: old)
    assert read({}) is None
    monkeypatch.setattr(trace, "records", lambda: [])
    assert read({}) is None


def test_live_ray_share_and_occluded_host_ms_read_the_shadow_spans(
        monkeypatch):
    from tracer_torch import trace
    b = Bench(MANIFEST)

    def frame(live, occluded_ns):
        r = _root([("nearest", {"rays": 100}),
                   ("shadow", {"live_rays": live, "slots": 100})]
                  + [("occluded", {"rays": 100})] * len(occluded_ns))
        for s, ns in zip(r["spans"][3:], occluded_ns):
            s["start_ns"], s["end_ns"] = 0, ns
        return r

    frames = [frame(4, [2_000_000]), frame(6, [1_000_000, 2_000_000]),
              frame(8, [5_000_000])]
    monkeypatch.setattr(trace, "records", lambda: frames)
    assert b.reader("live_ray_share.direct_100k")({}) == pytest.approx(0.06)
    assert b.reader("occluded_host_ms.direct_100k")({}) == pytest.approx(3.0)
    # A parent program: frames without the shadow span or shadow calls.
    bare = [_root([("nearest", {"rays": 100})])]
    monkeypatch.setattr(trace, "records", lambda: bare)
    assert b.reader("live_ray_share.direct_100k")({}) is None
    assert b.reader("occluded_host_ms.direct_100k")({}) is None


def test_anyhit_device_ms_reads_the_any_hit_walk_alone():
    read = Bench(MANIFEST).reader("anyhit_device_ms.direct_100k")
    ops = {"void leafwalk::walk_items<leafwalk::AnyhitWalk>(...)": [0.003, 2],
           "void leafwalk::walk_items<leafwalk::ClosestWalk<"
           "leafwalk::GridRows> >(...)": [0.010, 2]}
    dev = {"requests": 2, "busy_s": 0.02, "window_s": 0.05, "ops": ops}
    assert read({"device": dev}) == pytest.approx(1.5)
    assert read({"device": dev | {"ops": {"other": [0.01, 1]}}}) is None
    assert read({}) is None


def test_new_readers_return_nothing_without_the_program_trace(monkeypatch):
    """A program without ``tracer_torch.trace``: the new readers of the
    program's trace return None and raise nothing."""
    import sys

    import tracer_torch
    b = Bench(MANIFEST)
    monkeypatch.setitem(sys.modules, "tracer_torch.trace", None)
    monkeypatch.delattr(tracer_torch, "trace")
    for name in PROGRAM_READERS:
        assert b.reader(name)({}) is None, name
