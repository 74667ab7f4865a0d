"""Phase A's rows as one kernel (``conecull.phase_a_cuda``,
``csrc/phase_a.cu``): a row-at-a-time model of the kernel's algorithm
(``torch_parity.phase_a_row_model``: ascending 32-lane sweeps, ballot-order
appends, the keep budgets, raw counts, both fallback rules; at several
chunks one sweep over every group, per-chunk runs of its lists) against
the torch operations it replaces, ``candidate_rows`` (one chunk and
several, not exact) and ``tlas._pair_block_rows`` (routed pairs), bit for
bit; and the dispatch, which gives CPU tensors the torch operations.

The kernel itself runs only on the card; ``chip_smoke.py`` holds it to the
same torch operations there.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import tracer_torch as tt
from tests import torch_parity as tp
from tests.torch_parity import one_thread  # noqa: F401
from tracer_torch import trace
from tracer_torch.kernels import _lib
from tracer_torch.kernels import conecull as tc
from tracer_torch.kernels import tlas as ttlas


def _tables(n, leaf, max_chunk_bytes, seed):
    c, r, a = tp.scene_np(n, seed=seed, world=100.0)
    scene = tt.scene_from_numpy(c, r, a, device="cpu")
    bvh = tt.build_bvh(c, r, leaf_size=leaf, device="cpu")
    return tt.build_cone_tables(scene, bvh, max_chunk_bytes=max_chunk_bytes)


@pytest.fixture(scope="module")
def world():
    o, d = tp.origin_rays_np(4096, seed=2)
    feats, _ = tt.prep_feats_bucketed(torch.as_tensor(o), torch.as_tensor(d),
                                      tp.S, tp.SP, cell_bits=tp.CELL_BITS)
    return {
        # One chunk of 249 groups, its last group part padding: the 100k
        # query's regime (one chunk of 269 groups) at a CPU test's size.
        "one": _tables(12000, 4, 9 << 20, 5),
        # One chunk of 625 groups: more than the 512 a group prefix keeps.
        "wide": _tables(10000, 1, 64 << 20, 6),
        # Four chunks of 157 groups, the last one partial: routed pairs.
        "routed": _tables(10000, 1, 5 << 20, 6),
        # Two chunks of 157 groups, the last one partial: tables of a few
        # chunks, as the render's leaf-16 tables at 100k (three of 185).
        "two": _tables(5000, 1, 5 << 20, 6),
        "feats": feats,
    }


def synthetic_bounds(n, widths, seed):
    """(n, 12) f32 subpacket bounds [o_lo | o_hi | d_lo | d_hi]: origin
    boxes of side 0.02 round the scene's centre, direction boxes of half
    width ``widths[i % len]`` round random unit directions; a width past
    a component's size makes that axis straddle 0 (``free``)."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    w = np.asarray(widths)[np.arange(n) % len(widths)][:, None]
    o = rng.uniform(-0.01, 0.01, (n, 3))
    b = np.concatenate([o - 0.01, o + 0.01, d - w, d + w], axis=1)
    return torch.as_tensor(b.astype(np.float32))


def one_chunk_rows(bounds, tables, mg, mc):
    """candidate_rows at ``cone_candidates``' budgets, and the model with
    the arguments ``cone_candidates`` gives the kernel."""
    cull = tables.cull
    k0, k, kg, K_l, K0, rowlen = tc.cone_budgets(cull, mg, mc)
    rows, ovf = tc.candidate_rows(tuple(bounds[:, i:i + 3]
                                        for i in range(0, 12, 3)),
                                  cull, tables.leaf_boxes, k0, k, rowlen,
                                  exact=False)
    model = tp.phase_a_row_model(bounds, tables, tp.S, k0, k, kg, K_l, K0,
                                 rowlen)
    return (tp.np_(rows[0]), bool(ovf)), model, k0


def box_at_tnear_tfar(tables):
    """``tables`` with group 0 and its member leaves moved to the box
    [1, 2] x [1, 1.5] x [0.25, 0.5], and the bounds of a ray from the
    origin along (1, 0.5, 0.25): its slabs meet it over t in [1, 2],
    [2, 3] and [1, 2], so tnear == tfar == 2."""
    cull = tables.cull
    lpg = cull.leaves_per_group
    lo = torch.tensor([1.0, 1.0, 0.25])
    hi = torch.tensor([2.0, 1.5, 0.5])
    gmin, gmax = cull.group_min.clone(), cull.group_max.clone()
    gmin[0], gmax[0] = lo, hi
    boxes = tables.leaf_boxes.clone()
    for a in range(3):
        boxes[0, a * lpg:(a + 1) * lpg] = lo[a]
        boxes[0, (3 + a) * lpg:(4 + a) * lpg] = hi[a]
    moved = dataclasses.replace(
        tables, cull=dataclasses.replace(cull, group_min=gmin,
                                         group_max=gmax),
        leaf_boxes=boxes)
    ray = torch.tensor([0.0, 0, 0, 0, 0, 0, 1.0, 0.5, 0.25, 1.0, 0.5, 0.25])
    return moved, ray


def _group_rows(rows):
    return -rows[:, 0][rows[:, 0] < 0]


ONE_CHUNK = ["sorted", "leaf_budget", "keep_l", "padding", "free",
             "tnear_tfar", "overflow"]


@pytest.mark.parametrize("case", ONE_CHUNK)
def test_model_equals_one_chunk_rows(world, case):
    tables, mg, mc = world["one"], 64, 119
    if case == "sorted":
        bounds = torch.cat(tc.bounds_from_feats(world["feats"]), dim=1)
    elif case == "leaf_budget":
        bounds, mc = synthetic_bounds(64, (0.002, 0.01, 0.03, 0.1), 1), 16
    elif case == "keep_l":
        bounds, mg, mc = synthetic_bounds(64, (0.02, 0.1, 0.2, 0.3), 2), \
            256, 1024
    elif case == "padding":
        cull = tables.cull
        tables = dataclasses.replace(tables, cull=dataclasses.replace(
            cull, num_real_leaves=cull.num_real_leaves - 40))
        bounds = synthetic_bounds(32, (0.05, 2.0), 3)
    elif case == "free":
        bounds = synthetic_bounds(32, (0.3, 0.7, 1.2, 2.0), 4)
    elif case == "tnear_tfar":
        tables, ray = box_at_tnear_tfar(tables)
        bounds = torch.cat([ray[None].expand(tp.S, 12),
                            synthetic_bounds(tp.S, (0.01,), 5)])
    else:
        tables = world["wide"]
        bounds = synthetic_bounds(32, (0.01, 0.1, 2.0, 2.0), 6)
    (rows, ovf), (mrows, movf), k0 = one_chunk_rows(bounds, tables, mg, mc)
    np.testing.assert_array_equal(mrows, rows)
    assert movf == ovf
    cull = tables.cull
    lpc, gpc = cull.leaves_per_chunk, cull.num_groups
    groups = _group_rows(rows)
    if case == "sorted":
        assert (rows[:, 0] > 0).any() and not ovf
    elif case in ("leaf_budget", "keep_l"):
        # Group mode from the leaves alone: every group was refined.
        assert ((groups > 0) & (groups <= k0)).any()
        if case == "keep_l":
            assert (rows[:, 0] > 119).any()   # past the default budget
    elif case == "padding":
        real_g = -(-cull.num_real_leaves // cull.leaves_per_group)
        assert real_g < gpc and (groups == real_g).any()
        for row in rows:
            n = abs(int(row[0]))
            ids = row[1:n + 1]
            assert (ids < (real_g if row[0] < 0 else cull.num_real_leaves)
                    ).all()
    elif case == "free":
        # A row that meets every group lists the kg a row holds.
        assert (groups == min(gpc, rows.shape[1] - 9)).any() and ovf
    elif case == "tnear_tfar":
        assert 0 < rows[0, 0] < lpc and 0 in rows[0, 1:rows[0, 0] + 1]
    else:
        assert gpc > 512 and ovf          # a row past the kept prefix


@pytest.mark.parametrize("case", ["routed", "skewed"])
def test_model_equals_routed_rows(world, case):
    tables = world["routed"]
    cull = tables.cull
    C, gpc = cull.num_chunks, cull.leaves_per_chunk // cull.leaves_per_group
    S = tp.S
    if case == "routed":
        feats = world["feats"]
        g = feats.shape[0]
        mg, mc = 64, 119
        bounds = tc.bounds_from_feats(feats)
        # A pair budget past the C * g pairs leaves the last 8 inactive.
        npairs = C * g + 8
        pc, pg, act, _, _ = ttlas.route_pairs(*bounds, tables, S, npairs, C)
        rows = ttlas.tlas_candidates(feats, tables, mg, mc, npairs, C)[0]
        budgets = ttlas.pair_row_budgets(cull, mg, mc)
        ovf = None
        bounds = torch.cat(bounds, dim=1)
    else:
        gen = np.random.default_rng(7)
        npairs, g = 16, 6
        bounds = synthetic_bounds(g * S, (0.01, 0.1, 2.0), 8)
        pc = torch.as_tensor(np.r_[C - 1, gen.integers(0, C, npairs - 1)]
                             .astype(np.int32))
        pg = torch.as_tensor(gen.integers(0, g, npairs).astype(np.int32))
        act = torch.as_tensor(np.arange(npairs) % 5 != 4)
        budgets = ttlas.pair_row_budgets(cull, 64, 7)
        k0, k, kg, K_l, gkeep, rowlen = budgets
        rows, ovf = ttlas._pair_block_rows(
            bounds.reshape(g, S * 12), cull.group_min.reshape(C, gpc, 3),
            cull.group_max.reshape(C, gpc, 3), tables, pc, pg, act, S, k0,
            gkeep, k, kg, K_l, rowlen)
        ovf = bool(ovf)
    k0, k, kg, K_l, gkeep, rowlen = budgets
    mrows, movf = tp.phase_a_row_model(bounds, tables, S, k0, k, kg, K_l,
                                       gkeep, rowlen, pc, pg, act)
    rows = tp.np_(rows).reshape(-1, rowlen)
    np.testing.assert_array_equal(mrows, rows)
    assert not bool(act.all())                # inactive pairs
    assert (rows.reshape(-1, S, rowlen)[~tp.np_(act), :, 0] == 0).all()
    assert bool((pc == C - 1).any())           # the partial last chunk
    if case == "skewed":
        assert movf == ovf and ovf
    else:
        assert not movf and (rows[:, 0] > 0).any()


def escalation_ladder(cull, mg=48, mc=119):
    """The (max_groups, max_candidates) rungs ``leafcull._escalate``
    climbs from the render's budgets up to (G, lpc)."""
    rungs = [(mg, mc)]
    while not (mg >= cull.num_groups and mc >= cull.leaves_per_chunk):
        mg = min(2 * mg, cull.num_groups)
        mc = min(2 * mc, cull.leaves_per_chunk)
        rungs.append((mg, mc))
    return rungs


# The cull tables' sizes at the render's leaf 16 at 100k: three chunks of
# 185 groups, 2,960 leaves a chunk.
RENDER_CULL = types.SimpleNamespace(num_groups=555, leaves_per_chunk=2960,
                                    leaves_per_group=16)


@pytest.mark.parametrize("rung", range(6))
def test_render_ladder_keeps_512_groups_until_rung_four(rung):
    """On the render's tables kg is every group of a chunk on every rung,
    so a group-mode row is never cut at kg, and the group prefix K0 stays
    at 512 < G on rungs 0-3 and covers G from rung 4: overflow,
    ``(gcnt > kg) | (gtotal > K0)``, fires only where a subpacket meets
    more than 512 of the 555 groups, and then on every rung up to 4. An
    escalating call climbs exactly four rungs."""
    rungs = escalation_ladder(RENDER_CULL)
    assert rungs == [(48, 119), (96, 238), (192, 476), (384, 952),
                     (555, 1904), (555, 2960)]
    k0, k, kg, K_l, K0, rowlen = tc.cone_budgets(RENDER_CULL, *rungs[rung])
    gpc = RENDER_CULL.leaves_per_chunk // RENDER_CULL.leaves_per_group
    assert kg == gpc == 185
    assert (k0, K0) == [(48, 512), (96, 512), (192, 512), (384, 512),
                        (560, 640), (560, 640)][rung]
    assert (K0 < RENDER_CULL.num_groups) == (rung < 4)


MULTI_CHUNK =["sorted", "crossing", "leaf_budget", "keep_l", "past_k0",
               "overflow", "empty_chunk", "free"] + \
    [f"rung{i}" for i in range(6)]


@pytest.mark.parametrize("case", MULTI_CHUNK)
@pytest.mark.parametrize("chunks", ["two", "four"])
def test_model_equals_multi_chunk_rows(world, chunks, case):
    """The model of the multi-chunk kernel against ``candidate_rows`` at
    C > 1 (not exact), rows (C, P, rowlen) and overflow bit for bit, on
    two and four chunks, the last partial; each case's rows show what it
    exercises."""
    tables = world["two" if chunks == "two" else "routed"]
    cull = tables.cull
    C, G, lpc = cull.num_chunks, cull.num_groups, cull.leaves_per_chunk
    gpc = lpc // cull.leaves_per_group
    assert C == (2 if chunks == "two" else 4) and cull.num_real_leaves < G \
        * cull.leaves_per_group
    mg, mc = 64, 119
    if case == "sorted":
        bounds = torch.cat(tc.bounds_from_feats(world["feats"]), dim=1)
    elif case in ("crossing", "empty_chunk"):
        bounds = synthetic_bounds(64, (0.1,), 1)
    elif case == "leaf_budget":
        bounds, mc = synthetic_bounds(64, (0.1,), 1), 16
    elif case == "keep_l":
        bounds, mg, mc = synthetic_bounds(64, (0.02, 0.1, 0.2, 0.3), 1), \
            256, 1024
    elif case == "past_k0":
        bounds, mg = synthetic_bounds(64, (0.3, 0.5, 1.0), 1), 8
    elif case == "overflow":
        bounds, mc = synthetic_bounds(64, (0.3, 0.7, 1.2, 2.0), 1), 100
    elif case == "free":
        bounds = synthetic_bounds(32, (1.2, 2.0), 4)
    else:
        rungs = escalation_ladder(cull)
        assert len(rungs) == 6 and rungs[-1] == (G, lpc)
        mg, mc = rungs[int(case[4:])]
        bounds = synthetic_bounds(64, (0.005, 0.05, 0.1, 0.3, 2.0), 9)
    k0, k, kg, K_l, K0, rowlen = tc.cone_budgets(cull, mg, mc)
    rows, ovf = tc.candidate_rows(tuple(bounds[:, i:i + 3]
                                        for i in range(0, 12, 3)),
                                  cull, tables.leaf_boxes, k0, k, rowlen,
                                  exact=False)
    mrows, movf = tp.phase_a_row_model(bounds, tables, tp.S, k0, k, kg, K_l,
                                       K0, rowlen)
    rows, ovf = tp.np_(rows), bool(ovf)
    np.testing.assert_array_equal(mrows.reshape(rows.shape), rows)
    assert movf == ovf
    cnt = rows[:, :, 0]                                   # (C, P)
    shown = np.abs(np.minimum(cnt, 0))                    # groups listed
    leaf_rows, group_rows = (cnt > 0).any(0), (cnt < 0).any(0)
    if case == "sorted":
        assert leaf_rows.any() and not ovf
    elif case == "crossing":
        # The refine's groups in two chunks or more: leaf rows in both.
        assert ((cnt >= 0).all(0) & ((cnt > 0).sum(0) >= 2)).any()
    elif case == "leaf_budget":
        # One chunk's leaves past k, another's listed.
        assert (leaf_rows & group_rows).any()
    elif case == "keep_l":
        # Every group refined (at most k0 of them, each chunk's count
        # exact at kg = gpc) and every chunk in group mode: past K_l.
        assert kg == gpc and K_l < k
        assert ((cnt < 0).all(0) & (shown.sum(0) <= k0)).any()
    elif case == "past_k0":
        assert ((cnt < 0).all(0) & (shown.sum(0) > k0)).any()
    elif case == "overflow":
        # One chunk's groups past kg, the others' below; its groups and
        # theirs within K0, so the chunk's own count raised the flag.
        one = ((shown == kg).sum(0) == 1) & (cnt < 0).all(0)
        assert kg < gpc and ovf and one.any()
        assert (gpc + shown.sum(0) - kg <= K0)[one].any()
    elif case == "empty_chunk":
        assert ((cnt == 0).any(0) & (cnt != 0).any(0)).any()
    elif case == "free":
        # Every real group met: each chunk lists all of its own.
        real = -(-cull.num_real_leaves // cull.leaves_per_group)
        per_chunk = np.minimum(np.clip(real - np.arange(C) * gpc, 0, gpc),
                               kg)
        assert (shown == per_chunk[:, None]).all(0).any()


@pytest.mark.parametrize("shape", ["small_chunks", "many_groups"])
def test_model_equals_rows_of_any_table_size(shape):
    """The model against ``candidate_rows`` at C > 1 where the kernel's
    sweep meets what the render's tables do not: chunks of 16 groups, so
    one 32-lane step holds the end of one chunk and the start of the
    next (20 chunks), and 1,256 groups, past the 1,024 group boxes the
    kernel stages at a time (8 chunks); the kernel takes tables of any
    size, since its shared memory holds no list of groups."""
    if shape == "small_chunks":
        tables = _tables(5000, 1, 1 << 19, 6)
    else:
        tables = _tables(20000, 1, 5 << 20, 6)
    cull = tables.cull
    C, G = cull.num_chunks, cull.num_groups
    gpc = cull.leaves_per_chunk // cull.leaves_per_group
    assert (C, gpc) == ((20, 16) if shape == "small_chunks" else (8, 157))
    bounds = synthetic_bounds(48, (0.02, 0.1, 0.3, 1.2), 3)
    for mg, mc in ((64, 119), (G, cull.leaves_per_chunk)):
        k0, k, kg, K_l, K0, rowlen = tc.cone_budgets(cull, mg, mc)
        rows, ovf = tc.candidate_rows(tuple(bounds[:, i:i + 3]
                                            for i in range(0, 12, 3)),
                                      cull, tables.leaf_boxes, k0, k,
                                      rowlen, exact=False)
        mrows, movf = tp.phase_a_row_model(bounds, tables, tp.S, k0, k, kg,
                                           K_l, K0, rowlen)
        rows = tp.np_(rows)
        np.testing.assert_array_equal(mrows.reshape(rows.shape), rows)
        assert movf == bool(ovf)
        cnt = rows[:, :, 0]                               # (C, P)
        assert (cnt > 0).any() and (cnt < 0).any()
        # Chunks that start inside a step, or past the first 1,024
        # groups, list ids too.
        start = np.arange(C) * gpc
        late = start % 32 != 0 if shape == "small_chunks" else start >= 1024
        assert (cnt[late] != 0).any()


def test_cpu_tensors_take_the_torch_operations(world):
    """CPU tensors run the plain path: the kernel's launch counter stays,
    the span counts no ``kernels``, and the rows are the same with the
    trace on and off."""
    feats = world["feats"]
    launches = _lib.launches["phase_a_cuda"]
    one, routed = world["one"], world["routed"]
    C = routed.cull.num_chunks
    calls = (lambda: tc.cone_candidates(feats, one, 64, 119),
             lambda: ttlas.tlas_candidates(feats, routed, 64, 119,
                                           C * feats.shape[0], C))
    for call in calls:
        off = call()
        trace.reset()
        with trace.enabled():
            on = call()
        (a,) = [s for r in trace.records() for s in r["spans"]
                if s["name"] == "tracer_torch.phase_a"]
        assert a["counters"].get("kernels", 0) == 0
        assert torch.equal(off[0], on[0]) and bool(off[-1]) == bool(on[-1])
    trace.reset()
    assert _lib.launches["phase_a_cuda"] == launches


def test_phase_a_cuda_refuses_cpu_tensors(world):
    tables = world["one"]
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        tc.phase_a_cuda(synthetic_bounds(tp.S, (0.1,), 0), tables, tp.S, 64,
                        119, 119, 512, 512, 256)
