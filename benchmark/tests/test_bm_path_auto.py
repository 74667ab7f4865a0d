"""The frame cell of the renderer's default intersector, ``path_100k``,
on the CPU: a tiny copy of it (traffic ``path_800x600_auto`` cut to
64x48, configuration ``render_100k`` cut to the tiny scene) runs through the harness and passes its check, and
the readers it adds read the program's trace of frames.

On the CPU ``--impl auto`` takes the dense path at the tiny scene's 3,000
spheres (on the card, above 4,000, the leaf walk), so a second tiny cell
renders the same traffic through ``--impl leafcull``: the leaf walk's
plain version behind its escalating driver, whose phase A, compactor and
escalation the two new readers, ``group_row_share.path_100k`` and
``escalated_ray_share.path_100k``, read."""

from __future__ import annotations

import pytest
import torch

from benchmark.harness import HERE, Bench, load
from benchmark.tests import tiny

MANIFEST = HERE.parent / "BENCHMARK.json"
CELL = "path_100k"
CONFIG = "render_100k"
# tiny cell -> the traffic's impl
CELLS = {"tiny_path_auto": "auto", "tiny_path_leafcull": "leafcull"}
NEW_READERS = ("group_row_share.path_100k", "escalated_ray_share.path_100k")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """The tiny benchmark with the two cells added as files, each
    reporting what ``path_100k`` reports."""
    tmp = tmp_path_factory.mktemp("bm")
    tiny.make(tmp)
    root = tmp / "benchmark"
    real = load(MANIFEST)
    over = tiny.TRAFFIC["path_800x600_packets"]
    for name, impl in CELLS.items():
        tiny.write(root / "traffic" / f"{name}.json",
                   load(HERE / "traffic" / "path_800x600_auto.json") | over
                   | {"impl": impl})
        tiny.write(root / "limits" / f"{name}.json",
                   tiny.CELLS["tiny_path"][2])
    tiny.write(root / "configs" / "tiny_render.json",
               load(HERE / "configs" / f"{CONFIG}.json") | tiny.CONFIG)
    manifest = load(tmp / "BENCHMARK.json")
    manifest["workloads"] = [
        {"name": n, "config": "tiny_render", "traffic": n, "chips": 1,
         "why": "a test"} for n in CELLS]
    for m, r in zip(manifest["end_to_end"] + manifest["per_layer"],
                    real["end_to_end"] + real["per_layer"]):
        if "workloads" in m:
            m["workloads"] = list(CELLS) if CELL in r["workloads"] else []
    tiny.write(tmp / "BENCHMARK.json", manifest)
    return Bench(tmp / "BENCHMARK.json", root)


def test_the_cell_is_the_packet_cell_through_auto():
    auto = load(HERE / "traffic" / "path_800x600_auto.json")
    packets = load(HERE / "traffic" / "path_800x600_packets.json")
    assert auto == packets | {"impl": "auto"}
    b = Bench(MANIFEST)
    assert b.cell(CELL)["traffic"] == "path_800x600_auto"
    assert b.cell(CELL)["config"] == CONFIG
    assert {m["name"] for m in b.end_to_end(CELL)} == {
        "frame_ms", "frame_ms_p95", "setup_s"}
    names = {m["name"] for m in b.per_layer(CELL)}
    assert set(NEW_READERS) <= names and len(names) == 8
    assert all(m["moves"] == "frame_ms" for m in b.per_layer(CELL))


def test_the_config_is_the_100k_scene_through_the_renderer():
    """``render_100k`` renders the scene of ``spheres_100k`` (the same
    spheres from a seed) at the render leaf size, under a source of its
    own: the reference's frame loop."""
    b = Bench(MANIFEST)
    render, query = b.config(CONFIG), b.config("spheres_100k")
    scene = ("spheres", "world", "radius", "centers", "albedo", "precision")
    assert {k: render[k] for k in scene} == {k: query[k] for k in scene}
    assert render["bvh"] == {"builder": "native_sah",
                             "render_leaf_size":
                             query["bvh"]["render_leaf_size"]}
    entries = {c["name"]: c for c in b.manifest["configs"]}
    assert entries[CONFIG]["source"] == render["source"]
    assert "src/main.c:274-423" in render["source"]
    assert entries[CONFIG]["source"] != entries["spheres_100k"]["source"]
    assert [w["name"] for w in b.manifest["workloads"]
            if w["config"] == CONFIG] == [CELL]


@pytest.mark.parametrize("cell", list(CELLS))
def test_tiny_cell_runs_and_passes_its_check(bench, cell):
    line = tiny.run(bench, cell, seed=2 ** 31 + 23)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"frame_ms", "frame_ms_p95", "setup_s"}


def test_tiny_cell_fails_the_bfloat16_control(bench):
    line = tiny.run(bench, "tiny_path_auto", control="bfloat16")
    assert not line["correct"], line["checks"]


def test_new_readers_read_the_leaf_walks_frames(bench):
    from tracer_torch import trace
    trace.reset()
    line = tiny.run(bench, "tiny_path_leafcull", seed=2 ** 31 + 29,
                    trace=True)
    assert line["correct"], line["checks"]
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert 0.0 <= m["group_row_share.path_100k"] <= 1.0
    assert m["escalated_ray_share.path_100k"] >= 0.0
    assert 0.0 <= m["live_ray_share.path_100k"] <= 1.0
    assert m["render_host_ms.path_100k"] > 0.0


def _root(spans):
    """A frame's root as ``trace.records`` gives it."""
    root = {"name": "tracer_torch.render", "counters": {}}
    return root | {"spans": [root] + [{"name": "tracer_torch." + n,
                                       "counters": c} for n, c in spans]}


def test_escalated_ray_share_sums_a_frame(monkeypatch):
    from tracer_torch import trace
    b = Bench(MANIFEST)
    read = b.reader("escalated_ray_share.path_100k")
    frames = [
        _root([("nearest", {"rays": 1000}), ("phase_a", {"rows": 8}),
               ("escalate", {"escalated_rays": 1000}),
               ("nearest", {"rays": 500}),
               ("escalate", {"escalated_rays": 500}),
               ("escalate", {"escalated_rays": 500})]),
        _root([("nearest", {"rays": 1000}), ("nearest", {"rays": 1000})]),
        _root([("nearest", {"rays": 400}),
               ("escalate", {"escalated_rays": 400})])]
    monkeypatch.setattr(trace, "records", lambda: frames)
    assert read({}) == pytest.approx(1.0)      # median of 4/3, 0, 1
    # A program whose escalations count no rays reads nothing.
    old = [_root([("nearest", {"rays": 10}), ("escalate", {})])]
    monkeypatch.setattr(trace, "records", lambda: old)
    assert read({}) is None
    monkeypatch.setattr(trace, "records", lambda: [])
    assert read({}) is None


def test_new_readers_return_nothing_without_the_program_trace(monkeypatch):
    """A program without ``tracer_torch.trace``: both new readers return
    None and raise nothing."""
    import sys

    import tracer_torch
    b = Bench(MANIFEST)
    monkeypatch.setitem(sys.modules, "tracer_torch.trace", None)
    monkeypatch.delattr(tracer_torch, "trace")
    for name in NEW_READERS:
        assert b.reader(name)({}) is None, name
