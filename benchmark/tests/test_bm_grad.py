"""The inverse-rendering cell, ``grad_100k``, on the CPU: a tiny copy of it
(traffic ``grad_131k`` cut to 1,024 rays, configuration ``inverse_100k``
cut to 1,000 spheres at the same density) runs through the harness with
the port's checked soft evaluation and passes its check against the dense
plain reference, the bfloat16 control fails it, the readers it adds read
the program's trace of the evaluations, and without that trace they read
nothing."""

from __future__ import annotations

import pytest
import torch

from benchmark.harness import HERE, Bench, load
from benchmark.tests import tiny

MANIFEST = HERE.parent / "BENCHMARK.json"
CELL = "grad_100k"
CONFIG = "inverse_100k"
TRAFFIC = "grad_131k"
TINY = "tiny_grad"
# 1,000 spheres in a cube of side 215 are about as dense as 100,000 in
# one of side 1,000; blocks of 16 MiB cut the tiny evaluation in several,
# and a start of 2 leaves a subpacket escalates.
TINY_CONFIG = {"spheres": 1000, "world": 215.0}
TINY_TRAFFIC = {"rays": 1024, "pool": 2, "cell_bits": 4, "max_leaves": 2,
                "block_bytes": 1 << 24, "warmup_requests": 1,
                "trace_requests": 2, "check_requests": 2}
NEW_READERS = ("phase_a_host_ms.grad_100k", "escalated_ray_share.grad_100k",
               "candidate_fill.grad_100k", "device_allocs.grad_100k")
SEED = 2 ** 31 + 26


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """The tiny benchmark with the tiny grad cell added as files,
    reporting what ``grad_100k`` reports."""
    tmp = tmp_path_factory.mktemp("bm")
    tiny.make(tmp)
    root = tmp / "benchmark"
    real = load(MANIFEST)
    tiny.write(root / "traffic" / f"{TINY}.json",
               load(HERE / "traffic" / f"{TRAFFIC}.json") | TINY_TRAFFIC)
    tiny.write(root / "limits" / f"{TINY}.json",
               load(HERE / "limits" / f"{CELL}.json"))
    tiny.write(root / "configs" / f"{TINY}.json",
               load(HERE / "configs" / f"{CONFIG}.json") | TINY_CONFIG)
    manifest = load(tmp / "BENCHMARK.json")
    manifest["workloads"] = [{"name": TINY, "config": TINY,
                              "traffic": TINY, "chips": 1, "why": "a test"}]
    for m, r in zip(manifest["end_to_end"] + manifest["per_layer"],
                    real["end_to_end"] + real["per_layer"]):
        if "workloads" in m:
            m["workloads"] = [TINY] if CELL in r["workloads"] else []
    tiny.write(tmp / "BENCHMARK.json", manifest)
    return Bench(tmp / "BENCHMARK.json", root)


def test_the_cell_reports_evaluations_and_its_seven_readings():
    b = Bench(MANIFEST)
    wl = b.cell(CELL)
    assert (wl["config"], wl["traffic"], wl["chips"]) == (CONFIG, TRAFFIC, 1)
    assert b.traffic(TRAFFIC)["kind"] == "grad"
    assert {m["name"] for m in b.end_to_end(CELL)} == {
        "frame_ms", "frame_ms_p95", "setup_s"}
    names = {m["name"] for m in b.per_layer(CELL)}
    assert set(NEW_READERS) <= names and len(names) == 7
    assert all(m["moves"] == "frame_ms" and m["workloads"] == [CELL]
               for m in b.per_layer(CELL))
    assert set(b.limits(CELL)) == {"image_max_abs", "grad_rel_l2"}


def test_the_config_is_the_100k_scene_moved_as_cli_fit_moves_it():
    """``inverse_100k`` draws ``spheres_100k``'s spheres from a seed, at
    the same leaf size, with the soft model's defaults, cli fit's
    perturbation and the widths that reach the logit clip."""
    from tracer_torch.diff.soft import SoftParams
    from tracer_torch.diff.sparse import soft_radius_scale
    b = Bench(MANIFEST)
    inv, base = b.config(CONFIG), b.config("spheres_100k")
    scene = ("spheres", "world", "radius", "centers", "albedo", "precision")
    assert {k: inv[k] for k in scene} == {k: base[k] for k in scene}
    assert inv["bvh"]["leaf_size"] == base["bvh"]["leaf_size"] == 32
    params = SoftParams(**inv["soft"])
    assert params == SoftParams()
    assert soft_radius_scale(params, inv["bvh"]["inflate_widths"]) == 1.6
    assert inv["perturbation"] == {"center_sigma_radii": 0.1,
                                   "albedo_lift": 0.2,
                                   "albedo_clip": [0.05, 0.95]}
    assert inv["reduced"] == [] and len(inv["assumed"]) == 3
    entries = {c["name"]: c for c in b.manifest["configs"]}
    assert entries[CONFIG]["source"] == inv["source"]
    assert "BASELINE.json config 4" in inv["source"]


def test_tiny_cell_runs_and_passes_its_check(bench):
    line = tiny.run(bench, TINY, seed=SEED)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"frame_ms", "frame_ms_p95", "setup_s"}


def test_tiny_cell_fails_the_bfloat16_control(bench):
    line = tiny.run(bench, TINY, seed=SEED, control="bfloat16")
    assert not line["correct"], line["checks"]
    # By a margin, on both numbers, and not by a NaN.
    for name, c in line["checks"].items():
        assert 10 * c["limit"] < c["value"] < float("inf"), name


def test_new_readers_read_the_soft_evaluations(bench):
    from tracer_torch import trace
    trace.reset()
    line = tiny.run(bench, TINY, seed=SEED + 1, trace=True)
    assert line["correct"], line["checks"]
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert m["phase_a_host_ms.grad_100k"] > 0.0
    assert m["escalated_ray_share.grad_100k"] >= 1.0
    assert 0.0 < m["candidate_fill.grad_100k"] < 1.0
    # No device on the CPU: the device readers read nothing.
    for name in ("device_allocs.grad_100k", "compactor_device_ms.grad_100k",
                 "launches.grad_100k", "idle_share.grad_100k"):
        assert name not in m, name


def test_the_reference_takes_the_checked_side_of_the_clip_near_it():
    """Within ``band`` of the clip's ends a channel passes its gradient
    as ``clip_as`` does (strictly inside (0, 1)); elsewhere, and without
    ``clip_as``, as its own value does. The image does not change."""
    from benchmark.reference import soft
    g = torch.Generator().manual_seed(3)
    c = torch.rand((200, 3), generator=g) * 40 - 20
    r = torch.full((200,), 0.5)
    a = torch.rand((200, 3), generator=g)
    d = torch.randn((512, 3), generator=g)
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    o = torch.zeros_like(d)
    t = torch.zeros_like(d)
    own = soft.loss_grad(o, d, t, c, r, a, 50.0, 0.05)
    inside = torch.full_like(d, 0.5)
    for clip_as, band, same in ((inside, 0.0, True), (inside, 1.0, False),
                                (torch.ones_like(d), 1.0, False)):
        out = soft.loss_grad(o, d, t, c, r, a, 50.0, 0.05,
                             clip_as=clip_as, band=band)
        assert torch.equal(out[0], own[0]) and torch.equal(out[1], own[1])
        assert all(torch.equal(x, y) for x, y in zip(out[2], own[2])) \
            == same
    # Every channel near and clipped in ``clip_as``: no gradient at all.
    assert all(float(x.abs().max()) == 0.0 for x in out[2])


def _root(counters, spans):
    """An evaluation's root as ``trace.records`` gives it."""
    root = {"name": "tracer_torch.soft", "counters": counters}
    return root | {"spans": [root] + [{"name": "tracer_torch." + n,
                                       "counters": c, "start_ns": 0,
                                       "end_ns": ns} for n, c, ns in spans]}


def test_the_readers_take_the_median_over_evaluations(monkeypatch):
    from tracer_torch import trace
    b = Bench(MANIFEST)
    evals = [
        _root({"rays": 100, "device_allocs": 4},
              [("phase_a", {}, 2_000_000),
               ("escalate", {"escalated_rays": 100}, 9),
               ("phase_a", {}, 3_000_000),
               ("composite", {"lanes": 1000, "candidates": 100}, 1),
               ("composite", {"lanes": 1000, "candidates": 300}, 1)]),
        _root({"rays": 100, "device_allocs": 2},
              [("phase_a", {}, 1_000_000),
               ("composite", {"lanes": 1000, "candidates": 100}, 1)]),
        _root({"rays": 100, "device_allocs": 6},
              [("phase_a", {}, 1_000_000),
               ("escalate", {"escalated_rays": 100}, 9),
               ("phase_a", {}, 1_000_000),
               ("escalate", {"escalated_rays": 100}, 9),
               ("phase_a", {}, 2_000_000),
               ("composite", {"lanes": 1000, "candidates": 500}, 1)])]
    monkeypatch.setattr(trace, "records", lambda: evals)
    read = {n: b.reader(n)({}) for n in NEW_READERS}
    assert read["phase_a_host_ms.grad_100k"] == pytest.approx(4.0)
    assert read["escalated_ray_share.grad_100k"] == pytest.approx(1.0)
    assert read["candidate_fill.grad_100k"] == pytest.approx(0.2)
    assert read["device_allocs.grad_100k"] == pytest.approx(4.0)
    # Roots of other layers only: a parent program's query or frame.
    other = [evals[0] | {"name": "tracer_torch.render"}]
    monkeypatch.setattr(trace, "records", lambda: other)
    for name in NEW_READERS:
        assert b.reader(name)({}) is None, name


def test_new_readers_return_nothing_without_the_program_trace(monkeypatch):
    """A program without ``tracer_torch.trace``: the new readers of the
    program's trace return None and raise nothing."""
    import sys

    import tracer_torch
    b = Bench(MANIFEST)
    monkeypatch.setitem(sys.modules, "tracer_torch.trace", None)
    monkeypatch.delattr(tracer_torch, "trace")
    for name in NEW_READERS:
        assert b.reader(name)({}) is None, name
