"""The port's trace (``tracer_torch.trace``) on the CPU.

Three calls run with the trace on: a closest-hit query
(``prep_feats_bucketed`` then ``nearest_hit_hybrid_feats``, ~2,000
spheres), a routed query (``nearest_hit_tlas_feats`` over a table of
several chunks) and a 64x48 depth-5 compacted frame through the packet
walk (``--impl pallas``, ``traverse_plain`` on the CPU). Each must give
the span tree of its layers, every span's parent and one root id per
outermost call; each counter must equal a recount made without the trace
(the count column of phase A's rows, routing's pairs, the live paths of
each bounce, the packet walk's steps); the outputs must be bit-equal with
the trace on and off; and off, nothing is recorded and no
``record_function`` is entered. ``render --profile`` writes a Chrome
trace that names the program's spans, and ``--metrics`` then holds the
trace's counters beside the escalations of the checked queries.
"""

import json

import numpy as np
import pytest
import torch

import tracer_torch as tt
from tests import torch_parity as tp
from tracer_torch import cli, trace
from tracer_torch.integrator import wavefront as wf
from tracer_torch.intersect.cull import build_leaf_table
from tracer_torch.kernels import tlas as ttlas
from tracer_torch.kernels import traverse as ktrav
from tracer_torch.kernels.conecull import (bounds_from_feats,
                                           cone_candidates,
                                           nearest_hit_hybrid_feats)
from tracer_torch.kernels.cull import nearest_hit_cull_checked
from tracer_torch.kernels.leafcull import (nearest_hit_leafcull_checked,
                                           occluded_leafcull_checked)
from tracer_torch.kernels.tilecull import nearest_hit_tilecull_checked

S, SP, CELL_BITS = 8, 64, 4
QUERY = dict(spheres=2000, world=80.0, leaf=32, rays=2048, mg=64, mc=8)
ROUTED = dict(spheres=4096, world=150.0, leaf=8, rays=1024, chunk=1 << 18,
              mg=8, mc=7, npairs=4096, kc=32)
FRAME = ["render", "--device", "cpu", "--width", "64", "--height", "48",
         "--depth", "5", "--spheres", "1000", "--scene", "benchmark",
         "--world-size", "40", "--compact", "--impl", "pallas"]
# A step cap below the frame's walks, so that some packets count as
# resumed (the CPU walk has no cap; the count reads STEP_CAP).
CAP = 6
CASES = ["query", "routed", "frame"]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.reset()
    yield
    torch.set_num_threads(n)


def _scene(n, world, seed):
    rng = np.random.default_rng(seed)
    c = torch.as_tensor(rng.uniform(-world / 2, world / 2, (n, 3))
                        .astype(np.float32))
    r = torch.full((n,), 0.5)
    a = torch.as_tensor(rng.uniform(0, 1, (n, 3)).astype(np.float32))
    return tt.Scene(centers=c, radii=r, albedo=a)


def _dirs(n, seed):
    d = np.random.default_rng(seed).uniform(-1, 1, (n, 3)) \
        .astype(np.float32)
    return torch.as_tensor(d / np.linalg.norm(d, axis=1, keepdims=True))


@pytest.fixture(scope="module")
def setups():
    q = QUERY
    qscene = _scene(q["spheres"], q["world"], 1)
    qt = tt.build_cone_tables(qscene, tt.build_bvh(
        qscene.centers, qscene.radii, leaf_size=q["leaf"], device="cpu"))
    qd = _dirs(q["rays"], 2)
    r = ROUTED
    scene = _scene(r["spheres"], r["world"], 3)
    rt = tt.build_cone_tables(scene, tt.build_bvh(
        scene.centers, scene.radii, leaf_size=r["leaf"], device="cpu"),
        max_chunk_bytes=r["chunk"])
    assert rt.cull.num_chunks > 1
    o = torch.as_tensor(np.random.default_rng(4).uniform(
        -30, 30, (r["rays"], 3)).astype(np.float32))
    rfeats, _ = tt.prep_feats_bucketed(o, _dirs(r["rays"], 5), S, SP,
                                       cell_bits=CELL_BITS)
    session = cli.prepare(cli.build_parser().parse_args(FRAME))
    cfg = session.config
    noise = wf.bounce_noise(torch.Generator().manual_seed(6),
                            (cfg.height, cfg.width), cfg.max_depth)
    return dict(qscene=qscene, qtables=qt, qdirs=qd, rtables=rt,
                rfeats=rfeats, session=session, noise=noise)


def _run(case, st):
    """The case's call; its outputs as a tuple of tensors."""
    if case == "query":
        d = st["qdirs"]
        feats, dest = tt.prep_feats_bucketed(torch.zeros_like(d), d, S, SP,
                                             cell_bits=CELL_BITS)
        return (dest, *nearest_hit_hybrid_feats(
            feats, st["qtables"], QUERY["mg"], QUERY["mc"]))
    if case == "routed":
        r = ROUTED
        return ttlas.nearest_hit_tlas_feats(
            st["rfeats"], st["rtables"], r["mg"], r["mc"], r["npairs"],
            r["kc"])
    s = st["session"]
    return (s.frame(s.camera, st["noise"]),)


# name -> parent's name in each case's tree (roots map to None).
TREES = {
    "query": {"tracer_torch.prep": None, "tracer_torch.nearest": None,
              "tracer_torch.sync": "tracer_torch.prep",
              "tracer_torch.phase_a": "tracer_torch.nearest",
              "tracer_torch.compact": "tracer_torch.phase_a",
              "tracer_torch.walk": "tracer_torch.nearest"},
    "routed": {"tracer_torch.nearest": None,
               "tracer_torch.phase_a": "tracer_torch.nearest",
               "tracer_torch.route": "tracer_torch.phase_a",
               "tracer_torch.compact": ("tracer_torch.phase_a",
                                        "tracer_torch.route"),
               "tracer_torch.walk": "tracer_torch.nearest"},
    "frame": {"tracer_torch.render": None,
              "tracer_torch.bounce": "tracer_torch.render",
              "tracer_torch.compaction": "tracer_torch.bounce",
              "tracer_torch.nearest": "tracer_torch.bounce",
              "tracer_torch.walk": "tracer_torch.nearest",
              "tracer_torch.sync": ("tracer_torch.render",
                                    "tracer_torch.bounce",
                                    "tracer_torch.compaction")},
}
ROOTS = {"query": ["tracer_torch.prep", "tracer_torch.nearest"],
         "routed": ["tracer_torch.nearest"], "frame": ["tracer_torch.render"]}


def _spans(recs, name):
    return [s for r in recs for s in r["spans"] if s["name"] == name]


@pytest.mark.parametrize("case", CASES)
def test_span_tree_parents_and_root_ids(setups, case):
    with trace.enabled():
        _run(case, setups)
    recs = trace.records()
    assert [r["name"] for r in recs] == ROOTS[case]
    tree = TREES[case]
    ids = set()
    for rec in recs:
        by_id = {s["id"]: s for s in rec["spans"]}
        assert rec["spans"][0]["id"] == rec["id"] and rec["parent"] is None
        assert len(by_id) == len(rec["spans"])
        ids |= set(by_id)
        for s in rec["spans"]:
            assert s["root"] == rec["id"]
            assert s["start_ns"] <= s["end_ns"]
            want = tree[s["name"]]
            if s["parent"] is None:
                assert want is None and s is rec["spans"][0]
                continue
            parent = by_id[s["parent"]]
            assert parent["name"] in (want if isinstance(want, tuple)
                                      else (want,))
            assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= parent["end_ns"]
    assert {s["name"] for r in recs for s in r["spans"]} == set(tree)
    assert len(ids) == sum(len(r["spans"]) for r in recs)
    if case == "frame":
        depth = setups["session"].config.max_depth
        assert [s["arg"] for s in _spans(recs, "tracer_torch.bounce")] == \
            list(range(depth))
        assert len(_spans(recs, "tracer_torch.compaction")) == depth - 1
        assert len(_spans(recs, "tracer_torch.walk")) == depth


def _spy(monkeypatch, module, name, seen):
    real = getattr(module, name)

    def spy(*a, **k):
        out = real(*a, **k)
        seen.append((a, out))
        return out
    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("case", CASES)
def test_counters_equal_a_recount(setups, case, monkeypatch):
    if case == "frame":
        monkeypatch.setattr(ktrav, "STEP_CAP", CAP)
        compacted, walks = [], []
        _spy(monkeypatch, wf, "_compact_rays", compacted)
        _spy(monkeypatch, ktrav, "traverse_plain", walks)
    with trace.enabled():
        _run(case, setups)
    recs = trace.records()
    if case == "query":
        feats, _ = tt.prep_feats_bucketed(
            torch.zeros_like(setups["qdirs"]), setups["qdirs"], S, SP,
            cell_bits=CELL_BITS)
        rows, _, _ = cone_candidates(feats, setups["qtables"],
                                     QUERY["mg"], QUERY["mc"])
        cnt = rows[..., 0]
        (a,) = _spans(recs, "tracer_torch.phase_a")
        assert a["counters"] == {
            "rows": cnt.numel(), "group_rows": int((cnt < 0).sum())}
        assert 0 < a["counters"]["group_rows"] < cnt.numel()
        (n,) = _spans(recs, "tracer_torch.nearest")
        assert n["counters"] == {"rays": feats.shape[0] * S * SP,
                                 "syncs": 0}
    elif case == "routed":
        r, f, t = ROUTED, setups["rfeats"], setups["rtables"]
        C, g = t.cull.num_chunks, f.shape[0]
        npairs = min(r["npairs"], C * g)
        bounds = bounds_from_feats(f)
        _, _, every, _, _ = ttlas.route_pairs(*bounds, t, S, C * g, C)
        _, _, active, _, _ = ttlas.route_pairs(*bounds, t, S, npairs,
                                               min(r["kc"], C))
        rows = ttlas.tlas_candidates(f, t, r["mg"], r["mc"], npairs,
                                     min(r["kc"], C))[0]
        cnt = rows[..., 0]
        (route,) = _spans(recs, "tracer_torch.route")
        assert route["counters"] == {"pairs": int(every.sum()),
                                     "pair_budget": npairs}
        (a,) = _spans(recs, "tracer_torch.phase_a")
        assert a["counters"] == {
            "rows": int(active.sum()) * S,
            "group_rows": int((cnt < 0).sum())}
        assert a["counters"]["group_rows"] > 0
    else:
        bounces = _spans(recs, "tracer_torch.bounce")
        slots = setups["noise"][0].numel() // 3
        live = [slots] + [int(args[1].sum()) for args, _ in compacted]
        assert [b["counters"] for b in bounces] == [
            {"live_rays": n, "slots": slots} for n in live]
        assert 0 < live[-1] < live[1] < slots
        steps = [out[2] for _, out in walks]
        assert [w["counters"] for w in _spans(recs, "tracer_torch.walk")] \
            == [{"packets": s.numel(), "packet_steps": int(s.sum()),
                 "resumed_packets": int((s > CAP).sum())} for s in steps]
        assert sum(int((s > CAP).sum()) for s in steps) > 0


@pytest.fixture(scope="module")
def escalating():
    """Tables over which the checked drivers escalate at budgets (8, 1):
    4,000 spheres in two-sphere leaves, 900 origin rays and 900 shadow
    rays from points along them towards a light (as the render tests)."""
    c, r, a = tp.scene_np(4000, seed=13, world=80.0)
    _, scene = tp.scenes(c, r, a)
    tables = tt.build_cone_tables(scene, tt.build_bvh(c, r, leaf_size=2,
                                                      device="cpu"))
    o, d = tp.origin_rays_np(900, seed=14)
    rays = tt.Ray(torch.as_tensor(o), torch.as_tensor(d))
    hit_pt = rays.origin + 30.0 * rays.direction
    srays = tt.Ray(hit_pt, torch.tensor([0.0, 200.0, 0.0]) - hit_pt)
    return scene, tables, rays, srays


@pytest.fixture(scope="module")
def escalating_tiles(escalating):
    """The packed tree and leaf table of the tile and packet culls over the
    ``escalating`` scene in two-sphere leaves: a budget of one tile
    overflows."""
    scene = escalating[0]
    bvh = tt.build_bvh(scene.centers, scene.radii, leaf_size=2, device="cpu")
    return ktrav.pack_bvh(scene, bvh), build_leaf_table(bvh)


# kind -> (root span of its checked driver, the kind it tallies)
CHECKED = {"closest": ("tracer_torch.nearest", "closest"),
           "shadow": ("tracer_torch.occluded", "shadow"),
           "tilecull": ("tracer_torch.nearest", "closest"),
           "cull": ("tracer_torch.nearest", "closest")}


def _checked_driver(kind, escalating, escalating_tiles):
    """The checked driver of ``kind`` over the escalating tables from a
    budget that overflows: a call returning (result, escalations)."""
    scene, tables, rays, srays = escalating
    packed, table = escalating_tiles
    return {"closest": lambda: nearest_hit_leafcull_checked(
                rays, scene, tables, 8, 1, cell_bits=0),
            "shadow": lambda: occluded_leafcull_checked(
                srays, tables, 1.0, 8, 1, cell_bits=0),
            "tilecull": lambda: nearest_hit_tilecull_checked(
                rays, scene, packed, table, max_candidates=1),
            "cull": lambda: nearest_hit_cull_checked(
                rays, scene, packed, table, max_candidates=1)}[kind]


@pytest.mark.parametrize("kind", list(CHECKED))
def test_checked_drivers_count_rays_and_calls_once(escalating,
                                                   escalating_tiles, kind):
    """A checked driver that escalates counts, in its root, the caller's
    rays once (not the padded rays of each try), one call and its
    escalations; ``trace.tallied`` tallies the same with the trace off.
    The shadow driver is its own span, ``tracer_torch.occluded``."""
    driver = _checked_driver(kind, escalating, escalating_tiles)
    root_name, tally = CHECKED[kind]
    with trace.enabled():
        _, esc = driver()
    (root,) = trace.records()
    assert root["name"] == root_name
    assert esc >= 1
    assert root["counters"] == {"rays": 900, "calls": 1, "escalations": esc,
                                "syncs": 0}
    assert len(_spans([root], "tracer_torch.escalate")) == esc
    assert all("rays" not in s["counters"] for s in root["spans"][1:])
    counts = {}
    trace.tallied(counts, driver)()
    assert counts == {f"{tally}_calls": 1, f"{tally}_escalations": esc}


@pytest.mark.parametrize("kind", list(CHECKED))
def test_escalations_count_the_rays_they_walk_again(escalating,
                                                    escalating_tiles, kind):
    """Each retry of an escalating checked driver, the span
    ``tracer_torch.escalate``, counts ``escalated_rays``: every ray of the
    call, which the retry takes again (the leaf walks' drivers through
    phase A alone, the tile and packet culls' through the whole call); no
    other span counts it."""
    with trace.enabled():
        _, esc = _checked_driver(kind, escalating, escalating_tiles)()
    (root,) = trace.records()
    retries = _spans([root], "tracer_torch.escalate")
    assert esc >= 1 and [s["arg"] for s in retries] == list(range(1, esc + 1))
    assert all(s["counters"] == {"escalated_rays": 900} for s in retries)
    assert sum("escalated_rays" in s["counters"]
               for s in root["spans"]) == esc


def _traced(how: str):
    """The trace on: inside ``trace.enabled()``, or ("profiled") under a
    profiler that records shapes, so the ranges take their ids."""
    if how != "profiled":
        return trace.enabled()
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU], record_shapes=True)


@pytest.mark.parametrize("case", CASES + [c + ".profiled" for c in CASES])
def test_outputs_are_bit_equal_with_the_trace_on_and_off(setups, case):
    case, _, how = case.partition(".")
    off = _run(case, setups)
    with _traced(how):
        on = _run(case, setups)
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and torch.equal(a, b)


class _Refused:
    def __init__(self, *a, **k):
        raise AssertionError("record_function entered with the trace off")


@pytest.mark.parametrize("case", CASES)
def test_off_records_nothing_and_enters_no_range(setups, case, monkeypatch):
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _Refused)
    monkeypatch.setattr(torch.profiler, "record_function", _Refused)
    monkeypatch.setattr(torch.autograd, "_record_function_with_args_enter",
                        _Refused)
    assert not trace.on()
    _run(case, setups)
    assert trace.records() == []
    with pytest.raises(AssertionError, match="trace off"):
        with trace.enabled():
            _run(case, setups)


def test_the_store_keeps_the_last_roots():
    with trace.enabled():
        for i in range(trace.ROOTS + 5):
            with trace.span("bounce", i):
                trace.count(slots=i)
    recs = trace.records()
    assert len(recs) == trace.ROOTS
    assert [r["arg"] for r in recs] == list(range(5, trace.ROOTS + 5))
    assert [r["counters"]["slots"] for r in recs[:2]] == [5, 6]
    trace.reset()
    assert trace.records() == []


@pytest.mark.parametrize("impl", ["pallas", "leafcull"])
def test_render_profile_names_the_spans_and_metrics_keep_the_counts(
        tmp_path, impl):
    frames = 2
    argv = [a if a != "pallas" else impl for a in FRAME]
    cli.main(argv + ["--frames", str(frames), "--profile",
                     str(tmp_path / "p"), "--metrics",
                     str(tmp_path / "m.json"), "--out",
                     str(tmp_path / "f.png")])
    events = json.loads((tmp_path / "p" / "trace.json").read_text())
    names = {e.get("name", "") for e in events["traceEvents"]}
    for span in ("render", "bounce", "nearest", "walk", "compaction"):
        assert f"tracer_torch.{span}" in names, span
    # Each span is one event of the Chrome trace, by its id.
    ids = sorted(int(e["args"]["Concrete Inputs"][0])
                 for e in events["traceEvents"]
                 if e.get("cat") == "user_annotation"
                 and e["name"].startswith(trace.PREFIX)
                 and e["name"] != trace.PREFIX + "count")
    assert ids == sorted(s["id"] for r in trace.records()
                         for s in r["spans"])
    m = json.loads((tmp_path / "m.json").read_text())
    assert m["trace"]["roots"] == frames
    counters = m["trace"]["counters"]
    assert counters["tracer_torch.bounce"]["slots"] == frames * 5 * 64 * 48
    assert counters["tracer_torch.nearest"]["rays"] == frames * 5 * 64 * 48
    if impl == "pallas":
        assert m["escalations"] == {}
        assert counters["tracer_torch.walk"]["packets"] == frames * 5 * 3
    else:
        calls = frames * 5
        assert m["escalations"] == {"closest_calls": calls,
                                    "closest_escalations": counters[
                                        "tracer_torch.nearest"]["escalations"]}
        assert counters["tracer_torch.nearest"]["calls"] == calls


DIRECT = ["render", "--mode", "direct", "--device", "cpu", "--width", "64",
          "--height", "48", "--spheres", "1000", "--scene", "benchmark",
          "--world-size", "40", "--impl", "leafcull"]


@pytest.mark.parametrize("compact", [False, True])
def test_direct_frame_spans_and_shadow_counters(compact):
    """A traced direct frame (``--impl leafcull``: the checked closest-hit
    and shadow drivers) is one ``render`` root holding one ``nearest``
    call (its tries nested inside it) and one ``shadow`` span, with the
    ``occluded`` call inside it (and the wavefront's compaction, where
    on); ``shadow`` counts ``live_rays``, the frame's hit pixels, and
    ``slots``, the shadow query's rays. The frame is bit-equal with the
    trace off, which counts nothing."""
    from tracer_torch.scene.camera import camera_rays
    session = cli.prepare(cli.build_parser().parse_args(
        DIRECT + ["--compact" if compact else "--no-compact"]))
    cam, cfg = session.camera, session.config
    slots = cfg.width * cfg.height
    hits = int(session.nearest(session.scene)(camera_rays(cam, cfg))
               .hit.sum())
    assert 0 < hits < slots
    trace.reset()
    off = session.frame(cam, None)
    assert trace.records() == []
    with trace.enabled():
        on = session.frame(cam, None)
    assert torch.equal(on, off)
    (root,) = trace.records()
    assert root["name"] == "tracer_torch.render"
    by_id = {s["id"]: s for s in root["spans"]}

    def parent(s):
        return by_id[s["parent"]]["name"]

    def calls(name):
        """The outermost spans of ``name``: a checked driver's tries are
        spans of its name inside it."""
        return [s for s in _spans([root], name) if parent(s) != name]

    (nearest,) = calls("tracer_torch.nearest")
    (shadow,) = calls("tracer_torch.shadow")
    (occluded,) = calls("tracer_torch.occluded")
    assert parent(nearest) == parent(shadow) == "tracer_torch.render"
    assert parent(occluded) == "tracer_torch.shadow"
    compaction = _spans([root], "tracer_torch.compaction")
    assert [parent(s) for s in compaction] == (
        ["tracer_torch.shadow"] if compact else [])
    assert shadow["counters"] == {"live_rays": hits, "slots": slots}
    assert occluded["counters"] == {"rays": slots, "calls": 1,
                                    "escalations": 0}
    assert nearest["counters"]["rays"] == slots


@pytest.fixture(scope="module")
def soft_setup():
    """The checked soft evaluation's inputs: 1,500 spheres in a cube of
    side 100, single-chunk tables over radii inflated at widths 30,
    2,048 origin rays and a target image; from (8, 2) the ladder
    escalates."""
    from tracer_torch.diff import sparse
    from tracer_torch.diff.soft import SoftParams
    scene = _scene(1500, 100.0, 21)
    scale = sparse.soft_radius_scale(SoftParams(), widths=30.0)
    tables = tt.build_cull_tables(scene, tt.build_bvh(
        scene.centers, scene.radii * scale, leaf_size=32, device="cpu"))
    d = _dirs(2048, 22)
    rays = tt.Ray(origin=torch.zeros_like(d), direction=d)
    target = torch.full((2048, 3), 0.5)
    return scene, tables, rays, target


def _soft(soft_setup, **kw):
    from tracer_torch.diff import sparse
    scene, tables, rays, target = soft_setup
    return sparse.soft_loss_grad_sparse(scene, rays, target, tables,
                                        max_groups=8, max_leaves=2,
                                        cell_bits=CELL_BITS, **kw)


SOFT_TREE = {"tracer_torch.prep": "tracer_torch.soft",
             "tracer_torch.phase_a": ("tracer_torch.soft",
                                      "tracer_torch.escalate"),
             "tracer_torch.compact": "tracer_torch.phase_a",
             "tracer_torch.escalate": "tracer_torch.soft",
             "tracer_torch.sync": ("tracer_torch.phase_a", "tracer_torch.prep",
                                   "tracer_torch.soft"),
             "tracer_torch.composite": "tracer_torch.soft",
             "tracer_torch.backward": "tracer_torch.soft"}


def test_soft_root_spans_and_counters(soft_setup):
    """A traced soft evaluation is one ``soft`` root (``rays``, the
    caller's rays; ``blocks``; the checked call and its escalations)
    holding ``prep``, a ``phase_a`` a try (the retries inside their
    ``escalate`` spans, each counting every ray as ``escalated_rays``;
    phase A's ``rows`` and ``group_rows``, and no ``kernels``; each try's
    read of its overflow and leaf counts a ``sync`` span "phase_a" inside
    it), then a
    ``composite`` and a ``backward`` a block. ``lanes`` and
    ``candidates`` equal a recount from phase A's rows at the budgets
    that held: the rays times each subpacket's own listed slots, and the
    real (ray, sphere) pairs of each subpacket's own leaves. The plain
    version ran: no span counts ``kernels``, and on the CPU no span counts
    a sync."""
    from tracer_torch.diff import sparse
    scene, tables, rays, _ = soft_setup
    with trace.enabled():
        _, _, _, esc = _soft(soft_setup)
    (root,) = trace.records()
    assert root["name"] == "tracer_torch.soft" and root["parent"] is None
    assert esc >= 1
    assert root["counters"] == {"rays": 2048, "calls": 1,
                                "escalations": esc, "blocks": 1, "syncs": 0}
    by_id = {s["id"]: s for s in root["spans"]}
    for s in root["spans"][1:]:
        want = SOFT_TREE[s["name"]]
        want = want if isinstance(want, tuple) else (want,)
        assert by_id[s["parent"]]["name"] in want, s["name"]
        assert s["root"] == root["id"]
    tries = _spans([root], "tracer_torch.phase_a")
    retries = _spans([root], "tracer_torch.escalate")
    assert len(tries) == esc + 1 and len(retries) == esc
    assert all(s["counters"] == {"escalated_rays": 2048} for s in retries)
    reads = [by_id[s["parent"]]["name"] for s in
             _spans([root], "tracer_torch.sync") if s["arg"] == "phase_a"]
    assert reads == ["tracer_torch.phase_a"] * (esc + 1)
    assert sum(s["counters"].get("syncs", 0) for s in root["spans"]) == 0
    assert all("kernels" not in s["counters"] for s in root["spans"])
    padded, _ = tt.prep_rays_bucketed(rays, 64, CELL_BITS)
    P = padded.origin.shape[0] // 64
    for t in tries:
        assert t["counters"].get("kernels", 0) == 0
        assert t["counters"]["rows"] == P
        assert 0 <= t["counters"]["group_rows"] <= P
    k0, k = sparse.soft_budgets(tables, esc, 8, 2)
    ids, _ = sparse.candidate_sphere_ids(padded.origin, padded.direction,
                                         tables, k0, k)
    (_, _, n_eff, _), _ = sparse._soft_phase_a(
        padded.origin, padded.direction, tables, 64)(k0, k)
    (comp,) = _spans([root], "tracer_torch.composite")
    assert comp["counters"] == {
        "lanes": 64 * sum(n_eff) * tables.leaf_size,
        "candidates": int((ids >= 0).sum()) * 64}
    (back,) = _spans([root], "tracer_torch.backward")
    assert back["counters"] == {}


def test_soft_evaluation_bit_equal_with_the_trace_on_and_off(soft_setup):
    """The trace changes nothing of the evaluation, inside
    ``trace.enabled()`` or under a profiler, and off it records nothing;
    ``trace.tallied`` counts the call and its escalations as the kind
    ``soft`` either way."""
    trace.reset()
    off = _soft(soft_setup)
    assert trace.records() == []
    for how in ("enabled", "profiled"):
        with _traced(how):
            on = _soft(soft_setup)
        assert torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])
        for a, b in zip(on[2], off[2]):
            assert torch.equal(a, b)
        assert on[3] == off[3] >= 1
    counts = {}
    trace.tallied(counts, lambda: (_soft(soft_setup), 0))()
    assert counts == {"soft_calls": 1, "soft_escalations": off[3]}
