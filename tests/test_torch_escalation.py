"""Escalation of the leaf walks' checked drivers
(``leafcull.nearest_hit_leafcull_checked``, ``occluded_leafcull_checked``):
prep runs once a call, phase A once a try at the doubled budgets of
``leafcull._escalate``, and the walk once, over the rows of the last try.

The result equals bit for bit the one-try query (``nearest_hit_leafcull``,
``occluded_leafcull``) at the budgets the ladder ends on, the escalations
are the rungs the one-try query overflows on, and each stage runs as often
as that says, counted both from the trace's spans and by wrapping the
stages with the trace off.
"""

import pytest
import torch

import tracer_torch as tt
from tests import torch_parity as tp
from tests.torch_parity import one_thread  # noqa: F401
from tracer_torch import trace
from tracer_torch.kernels import conecull, leafcull

# budgets -> whether the call escalates over the scene below
BUDGETS = {"ladder": ((8, 1), True), "holds": ((48, 119), False)}
KINDS = ("closest", "shadow")


@pytest.fixture(scope="module")
def world():
    """4,000 spheres in two-sphere leaves, 900 origin rays and 900 shadow
    rays from points along them towards a light (unnormalised directions,
    t_max 1): at budgets (8, 1) both queries overflow and escalate."""
    c, r, a = tp.scene_np(4000, seed=13, world=80.0)
    scene = tt.scene_from_numpy(c, r, a, device="cpu")
    tables = tt.build_cone_tables(scene, tt.build_bvh(c, r, leaf_size=2,
                                                      device="cpu"))
    o, d = tp.origin_rays_np(900, seed=14)
    rays = tt.Ray(torch.as_tensor(o), torch.as_tensor(d))
    hit_pt = rays.origin + 30.0 * rays.direction
    srays = tt.Ray(hit_pt, torch.tensor([0.0, 200.0, 0.0]) - hit_pt)
    return scene, tables, rays, srays


def _checked(kind, world, budgets):
    """The checked driver of ``kind`` at ``budgets``: (result,
    escalations)."""
    scene, tables, rays, srays = world
    if kind == "closest":
        return leafcull.nearest_hit_leafcull_checked(
            rays, scene, tables, *budgets, cell_bits=0)
    return leafcull.occluded_leafcull_checked(srays, tables, 1.0, *budgets,
                                              cell_bits=0)


def _one_try(kind, world, budgets):
    """The unchecked query of ``kind`` at ``budgets``: (result,
    overflow)."""
    scene, tables, rays, srays = world
    if kind == "closest":
        return leafcull.nearest_hit_leafcull(rays, scene, tables, *budgets,
                                             cell_bits=0)
    return leafcull.occluded_leafcull(srays, tables, 1.0, *budgets,
                                      cell_bits=0)


def _ladder(world, budgets):
    """The rungs ``_escalate`` climbs from ``budgets``: every budget pair
    up to the one that covers the tables."""
    grow = leafcull._doubled_budgets(world[1])
    rungs = [budgets]
    while (nxt := grow(rungs[-1])) is not None:
        rungs.append(nxt)
    return rungs


@pytest.mark.parametrize("budget", list(BUDGETS))
@pytest.mark.parametrize("kind", KINDS)
def test_checked_equals_the_one_try_query_at_the_last_rung(world, kind,
                                                           budget):
    """The checked result equals bit for bit the one-try result at the
    budgets the ladder ends on, and the escalations are the rungs below
    the first on which the one-try query does not overflow."""
    start, escalates = BUDGETS[budget]
    got, esc = _checked(kind, world, start)
    rungs = _ladder(world, start)
    overflows = [bool(_one_try(kind, world, b)[1]) for b in rungs]
    assert overflows[0] == escalates
    want_esc = overflows.index(False) if False in overflows \
        else len(rungs) - 1
    assert esc == want_esc and (esc >= 1) == escalates
    want, _ = _one_try(kind, world, rungs[esc])
    if kind == "closest":
        for field in ("index", "t", "hit", "point", "normal"):
            a, b = getattr(got, field), getattr(want, field)
            assert a.dtype == b.dtype and torch.equal(a, b), field
        assert int(got.hit.sum()) > 30
    else:
        assert got.dtype == torch.bool and torch.equal(got, want)
        assert 0 < int(got.sum()) < 900


@pytest.mark.parametrize("budget", list(BUDGETS))
@pytest.mark.parametrize("kind", KINDS)
def test_prep_and_walk_once_phase_a_each_try_in_the_trace(world, kind,
                                                          budget):
    """In a checked call's spans: one ``prep``, one ``walk``, a
    ``phase_a`` for each try (1 + escalations), and each ``escalate``
    span wraps one retried phase A and nothing else."""
    start, _ = BUDGETS[budget]
    trace.reset()
    with trace.enabled():
        _, esc = _checked(kind, world, start)
    (root,) = trace.records()
    trace.reset()
    names = [s["name"][len(trace.PREFIX):] for s in root["spans"]]
    assert names.count("prep") == 1
    assert names.count("walk") == 1
    assert names.count("phase_a") == 1 + esc
    assert names.count("escalate") == esc
    # prep, then the tries, then the walk: no walk before the last try.
    assert names.index("prep") < names.index("phase_a")
    assert names.index("walk") > max(i for i, n in enumerate(names)
                                     if n == "phase_a")
    by_id = {s["id"]: s for s in root["spans"]}
    for s in root["spans"]:
        if s["name"] == trace.PREFIX + "phase_a":
            parent = by_id[s["parent"]]["name"][len(trace.PREFIX):]
            assert parent in ("escalate", root["name"][len(trace.PREFIX):])
    retried = [s for s in root["spans"] if s["parent"] is not None
               and by_id[s["parent"]]["name"] == trace.PREFIX + "escalate"]
    assert [s["name"] for s in retried] == [trace.PREFIX + "phase_a"] * esc


@pytest.mark.parametrize("budget", list(BUDGETS))
@pytest.mark.parametrize("kind", KINDS)
def test_prep_and_walk_once_phase_a_each_try_with_the_trace_off(
        world, kind, budget, monkeypatch):
    """With the trace off, the stages wrapped and counted: prep and the
    walk run once a call, phase A 1 + escalations times, and the walk
    takes the rows of phase A's last try."""
    calls = {"prep": 0, "phase_a": 0, "walk": 0}
    last_rows = []

    def counted(name, fn, keep_rows=False):
        def run(*args, **kwargs):
            calls[name] += 1
            out = fn(*args, **kwargs)
            if keep_rows:
                last_rows[:] = [out[0]]
            return out
        return run

    walk = "leafcull_call" if kind == "closest" else "anyhit_call"
    real_walk = getattr(conecull, walk)

    def walked(feats, rows, *args):
        calls["walk"] += 1
        assert rows.data_ptr() == last_rows[0].data_ptr()
        return real_walk(feats, rows, *args)

    monkeypatch.setattr(leafcull, "prep_feats_bucketed",
                        counted("prep", leafcull.prep_feats_bucketed))
    monkeypatch.setattr(conecull, "cone_candidates",
                        counted("phase_a", conecull.cone_candidates,
                                keep_rows=True))
    monkeypatch.setattr(conecull, walk, walked)
    assert not trace.on()
    _, esc = _checked(kind, world, BUDGETS[budget][0])
    assert calls == {"prep": 1, "phase_a": 1 + esc, "walk": 1}
