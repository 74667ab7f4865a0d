"""PyTorch port vs the JAX package: the phase-B cone-cull walk and its
queries.

``conecull_call`` on CPU tensors runs ``conecull_plain``, the plain version
of the CUDA kernel ``conecull_cuda``. Tolerances:

* the port's ``nearest_hit_conecull_t`` against JAX's (Pallas in interpret
  mode, compiled once per module) on ``prep_rays_bucketed`` rays: sphere ids
  exactly, t to 1e-5 relative plus the propagated rounding of grazing rays
  (``torch_parity.assert_walk_t_close``: XLA on the CPU contracts mul+add
  into FMA where the port rounds each op);
* ``conecull_call`` against ``leafcull_call`` on the same rows: t and slots
  bit for bit (the cone test only drops prims no ray of the subpacket can
  accept), in four settings: default budgets, group-mode rows, C > 1
  chunks, and unsorted rays whose cones are degenerate;
* the checked query against ``nearest_hit_brute``: ids exactly;
* ``nearest_hit_conecull_t`` against ``nearest_hit_hybrid_t``: t and ids
  exactly;
* on skewed rows (``torch_parity.tie_leaves`` with narrow ray bundles, at
  leaf sizes 16 and 32 in two chunks: one row walks every group, one
  sphere is stored twice for exact u ties, one subpacket's cone is
  degenerate): ``conecull_plain`` against JAX ``_conecull_call`` (slots
  exactly, t to the leaf-walk tolerance) and against ``leafcull_plain``
  (t and slots bit for bit);
* the CUDA kernel's split (rows cut into items, each item's prims
  cone-filtered, the survivors' (-u, slot) keys min-merged over items,
  kept summed over items) modelled with the plain pieces: equal to
  ``conecull_plain`` bit for bit at 1, 3 and 8 leaves per item.
"""

import types

import numpy as np
import pytest
import torch

import tracer_torch as tt
from tests import torch_parity as tp
from tests.torch_parity import one_thread  # noqa: F401
from tracer.core.types import Ray as JRay
from tracer.kernels import conecull as jcone
from tracer_torch.kernels import _lib, conecull as tcone, tilewalk as tw
from tracer_torch.kernels.leafcull import (MISS_KEY, leafcull_call,
                                           leafcull_plain, pack_ray_features,
                                           ray_prim_u, _min_merge_chunks,
                                           _walk_pairs, _BIG, _NOSLOT)

N, LEAF, B = 500, 8, 512
# A scene with more groups than a group-mode row lists at small budgets.
N_DENSE = 16000
CHUNK_BYTES = 80 * 1024
# case -> (max_chunk_bytes, unsorted rays?, max_candidates)
WALK_CASES = {
    "default": (9 << 20, False, 119),
    "group_mode": (9 << 20, False, 7),
    "chunked": (CHUNK_BYTES, False, 119),
    "unsorted_degenerate": (9 << 20, True, 119),
}


@pytest.fixture(scope="module")
def world():
    """A 500-sphere scene, its 8-leaf tree, cone tables on both sides
    (asserted equal), and 512 origin rays, raw and through the port's
    ``prep_rays_bucketed``."""
    c, r, a = tp.scene_np(N, seed=3)
    jscene, tscene = tp.scenes(c, r, a)
    jb, tb = tp.bvhs(c, r, LEAF)
    tables = {}
    for mcb in (9 << 20, CHUNK_BYTES):
        jt = jcone.build_cone_tables(jscene, jb, max_chunk_bytes=mcb)
        t = tt.build_cone_tables(tscene, tb, max_chunk_bytes=mcb)
        tp.assert_cone_tables_match(jt, t)
        tables[mcb] = (jt, t)
    assert tables[CHUNK_BYTES][1].cull.num_chunks > 1
    o, d = (torch.as_tensor(x) for x in tp.origin_rays_np(B, seed=4))
    padded, dest = tt.prep_rays_bucketed(tt.Ray(origin=o, direction=d),
                                         tp.SP, cell_bits=tp.CELL_BITS)
    return dict(scene=(jscene, tscene), tables=tables, rays=(o, d),
                padded=padded, dest=dest)


@pytest.fixture(scope="module")
def jax_conecull(world):
    """JAX nearest_hit_conecull_t on the padded rays (interpret mode)."""
    padded = world["padded"]
    t, sid, ovf = jcone.nearest_hit_conecull_t(
        JRay(origin=tp.to_jax(padded.origin),
             direction=tp.to_jax(padded.direction)),
        world["tables"][9 << 20][0], subpackets=tp.S, subpacket=tp.SP,
        interpret=True)
    return tp.np_(t), tp.np_(sid), bool(ovf)


def test_conecull_t_matches_jax(world, jax_conecull):
    tables = world["tables"][9 << 20][1]
    padded = world["padded"]
    t, sid, ovf = tt.nearest_hit_conecull_t(padded, tables, subpackets=tp.S,
                                            subpacket=tp.SP)
    jt, jsid, jovf = jax_conecull
    assert not bool(ovf) and not jovf
    assert sid.dtype == torch.int32 and tuple(t.shape) == jt.shape
    np.testing.assert_array_equal(tp.np_(sid), jsid)
    hit = jsid >= 0
    assert hit.any() and not hit.all()
    assert np.isinf(tp.np_(t)[~hit]).all()
    scene = world["scene"][1]
    tp.assert_ray_t_close(t, jt, padded.origin, padded.direction, sid,
                          scene.centers, scene.radii, rtol=1e-5)


def _rows(world, case):
    """(feats, rows (C, G, S, rowlen), cones (G, S, CONE_FEAT), cull) of a
    walk case."""
    mcb, unsorted, mc = WALK_CASES[case]
    tables = world["tables"][mcb][1]
    o, d = world["rays"]
    if unsorted:
        feats, _, _ = pack_ray_features(o, d, tp.S, tp.SP)
    else:
        feats, _ = tt.prep_feats_bucketed(o, d, tp.S, tp.SP,
                                          cell_bits=tp.CELL_BITS)
    rows, _, ovf = tt.cone_candidates(feats, tables, 64, mc)
    assert not bool(ovf)
    cones = tcone.cone_from_feats(feats, *tcone.bounds_from_feats(feats),
                                  tables.r_max)
    cull = tables.cull
    G = feats.shape[0]
    return (feats, rows.reshape(cull.num_chunks, G, tp.S, -1),
            cones.reshape(G, tp.S, -1), cull)


def _walked_prims(rows, cull):
    nc = rows[..., 0].long()
    leaves = nc.clamp(min=0) + (-nc).clamp(min=0) * cull.leaves_per_group
    return leaves * cull.leaf_size


@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_conecull_call_equals_leafcull_bit_for_bit(world, case):
    feats, rows, cones, cull = _rows(world, case)
    args = (cull.prims, cull.leaf_size, cull.leaves_per_chunk,
            cull.leaves_per_group)
    t, slot, kept = tt.conecull_call(feats, rows, cones, *args)
    t_l, slot_l = leafcull_call(feats, rows, *args)
    assert torch.equal(slot, slot_l) and torch.equal(t, t_l)
    assert kept.dtype == torch.int32 and kept.shape == rows.shape[:3]
    hit = slot < 2 ** 30
    assert hit.any() and not hit.all()
    walked = _walked_prims(rows, cull)
    assert (kept <= walked).all() and kept.sum() > 0
    degenerate = cones[..., 6] >= 1e17
    if case == "unsorted_degenerate":
        assert degenerate.all()
        # Accept-all cones keep every walked slot that holds a sphere.
        G, S = cones.shape[:2]
        q, leaf = _walk_pairs(rows.reshape(-1, rows.shape[-1]),
                              cull.leaves_per_group)
        gslot = ((q // (G * S)) * cull.leaves_per_chunk + leaf)[:, None] \
            * cull.leaf_size + torch.arange(cull.leaf_size)
        real = (cull.slot_to_sphere[gslot] >= 0).sum(dim=1)
        want = torch.zeros(rows.shape[:3]).reshape(-1).long() \
            .index_add_(0, q, real)
        np.testing.assert_array_equal(tp.np_(kept).reshape(-1),
                                      tp.np_(want))
    else:
        assert not degenerate.any()
        assert kept.sum() < walked.sum()           # the cones cull prims
    if case == "group_mode":
        assert (rows[..., 0] < 0).any()
    if case == "chunked":
        assert rows.shape[0] > 1


def test_conecull_plain_slicing_does_not_change_results(world):
    feats, rows, cones, cull = _rows(world, "group_mode")
    args = (feats, rows, cones, cull.prims, cull.leaf_size,
            cull.leaves_per_chunk, cull.leaves_per_group)
    whole = tcone.conecull_plain(*args)
    pairs = int(_walked_prims(rows, cull).sum()) // cull.leaf_size
    step = pairs // 6 + 1                       # several slices, not one
    sliced = tcone.conecull_plain(*args,
                                  pair_elems=step * tp.SP * cull.leaf_size)
    assert all(torch.equal(a, b) for a, b in zip(whole, sliced))


def test_conecull_t_equals_hybrid_t(world):
    tables = world["tables"][CHUNK_BYTES][1]
    padded = world["padded"]
    kw = dict(max_candidates=7, subpackets=tp.S, subpacket=tp.SP)
    t, sid, ovf = tt.nearest_hit_conecull_t(padded, tables, **kw)
    t_h, sid_h, ovf_h = tt.nearest_hit_hybrid_t(padded, tables, **kw)
    assert not bool(ovf) and not bool(ovf_h)
    assert torch.equal(sid, sid_h) and torch.equal(t, t_h)


def test_conecull_checked_equals_brute(world):
    """The checked query on the padded rays, and on unsorted rays over a
    denser scene whose group-mode rows overflow until it escalates."""
    jscene, tscene = world["scene"]
    tables = world["tables"][9 << 20][1]
    padded = world["padded"]
    rec, esc = tt.nearest_hit_conecull_checked(padded, tscene, tables,
                                               subpackets=tp.S,
                                               subpacket=tp.SP)
    ref = tt.nearest_hit_brute(padded, tscene)
    assert esc == 0
    np.testing.assert_array_equal(tp.np_(rec.index), tp.np_(ref.index))
    o, d = world["rays"]
    rec_o = rec.index[world["dest"]]
    np.testing.assert_array_equal(
        tp.np_(rec_o), tp.np_(tt.nearest_hit_brute(
            tt.Ray(origin=o, direction=d), tscene).index))

    c, r, a = tp.scene_np(N_DENSE, seed=4, world=200.0)
    _, dense = tp.scenes(c, r, a)
    dt = tt.build_cone_tables(dense, tp.bvhs(c, r, LEAF)[1])
    rays = tt.Ray(origin=o[:256], direction=d[:256])
    _, _, ovf = tt.nearest_hit_conecull_t(rays, dt, 8, 7, tp.S, tp.SP)
    assert bool(ovf)
    rec, esc = tt.nearest_hit_conecull_checked(rays, dense, dt, 8, 7,
                                               subpackets=tp.S,
                                               subpacket=tp.SP)
    assert esc >= 1
    ref = tt.nearest_hit_brute(rays, dense)
    np.testing.assert_array_equal(tp.np_(rec.index), tp.np_(ref.index))
    assert (tp.np_(ref.index) >= 0).any()


def test_conecull_wrappers_run_plain_on_cpu_and_refuse_others(world):
    _lib.launches.clear()
    feats, rows, cones, cull = _rows(world, "default")
    args = (cull.prims, cull.leaf_size, cull.leaves_per_chunk,
            cull.leaves_per_group)
    t, slot, kept = tt.conecull_call(feats, rows, cones, *args)
    tp_, sp_, kp_ = tcone.conecull_plain(feats, rows, cones, *args)
    assert torch.equal(t, tp_[0]) and torch.equal(slot, sp_[0])
    assert torch.equal(kept, kp_)
    meta = [x.to("meta") for x in (feats, rows, cones, cull.prims)]
    with pytest.raises(ValueError, match="CUDA"):
        tt.conecull_call(*meta, *args[1:])
    with pytest.raises(ValueError, match="CUDA"):
        tcone.conecull_cuda(feats, rows, cones, *args)
    with pytest.raises(ValueError, match="cones"):
        tt.conecull_call(feats, rows, cones[:, :1], *args)
    assert not _lib.launches


# ---------------------------------------------------------------------------
# skewed rows, and the kernel's split of them into items
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[16, 32], ids=["leaf16", "leaf32"])
def cone_tie(request):
    """tie_leaves' skewed two-chunk rows at leaf size 16 or 32 with ray
    bundles, their cones (built as the phase-B path builds them) and
    conecull_plain's per-chunk (t, slot, kept)."""
    feats, cand, prims, ls, lpc, lpg = tp.tie_leaves(
        45, leaf_size=request.param, bundles=True)
    G, S = feats.shape[:2]
    cones = tcone.cone_from_feats(feats, *tcone.bounds_from_feats(feats),
                                  3.0).reshape(G, S, -1)   # r_max: the dup
    args = (prims, ls, lpc, lpg)
    return dict(feats=feats, cand=cand, cones=cones, args=args,
                whole=tcone.conecull_plain(feats, cand, cones, *args))


def test_skewed_phase_b_rows_match_jax_and_leaf_walk(cone_tie):
    feats, cand, cones = cone_tie["feats"], cone_tie["cand"], cone_tie["cones"]
    prims, ls, lpc, lpg = cone_tie["args"]
    t, slot, kept = cone_tie["whole"]
    t_l, slot_l = leafcull_plain(feats, cand, *cone_tie["args"])
    assert torch.equal(slot, slot_l) and torch.equal(t, t_l)
    G, S, SP = feats.shape[:3]
    jt, js = jcone._conecull_call(
        tp.jfeats(feats), tp.to_jax(cand),
        tp.to_jax(cones.reshape(G, 1, S, -1)),
        tp.prims_to_entries(prims, ls), S, SP, ls, lpc, lpg, interpret=True)
    tm, sm = _min_merge_chunks(t, slot)
    np.testing.assert_array_equal(tp.np_(sm), tp.np_(js))
    tp.assert_walk_t_close(tm, tp.np_(jt), feats, sm, prims)
    dup = tp.leaf_dup(ls)
    assert (sm == dup[0]).sum() > 5 and not (sm == dup[1]).any()
    assert ((sm[1] < _NOSLOT).sum(dim=0) > 0).all()   # both bundles of
                                                      # packet 1 hit
    degenerate = cones[..., 6] >= 1e17
    assert degenerate.sum() == 1 and bool(degenerate[0, 1])
    walked = _walked_prims(cand, types.SimpleNamespace(
        leaf_size=ls, leaves_per_group=lpg))
    assert torch.equal(kept[:, degenerate], walked[:, degenerate].int())
    tight = ~degenerate & (walked > 0)
    assert (kept[tight] < walked[tight]).all() and kept[tight].sum() > 0


def cone_split_merge(feats, cand, cones, prims, ls, lpc, lpg, chunk):
    """conecull_cuda's split modelled with the plain pieces: each row's
    walked leaves cut into items of ``chunk`` leaves (the wrapper's item
    plan), each item's prims cone-tested (leaves at or past lpc hold no
    prim) and its survivors counted into kept, each survivor's (-u, slot)
    key min-merged per item and then over the row's items, and the keys
    unpacked as the epilogue does: t = (-u) * (1/a), (3e38, 2^30) for a
    miss. Returns per-chunk (t, slot) (C, G, SP, S) and kept (C, G, S)."""
    G, S, SP, F = feats.shape
    C = cand.shape[0]
    row, sub = tp.leaf_item_rows(cand, lpg, chunk)
    fidx, c = row % (G * S), row // (G * S)
    q, leaf = _walk_pairs(sub, lpg)                  # q: the item
    inside = leaf < lpc
    q, leaf = q[inside], leaf[inside]
    pslot = leaf[:, None] * ls + torch.arange(ls)
    pr = prims[c[q][:, None], pslot]                 # (n, ls, 4)
    keep = tcone.cone_keep(cones.reshape(G * S, -1)[fidx[q]], pr)
    kept = torch.zeros(C * G * S, dtype=torch.int64) \
        .index_add_(0, row[q], keep.sum(dim=1))
    pi, li = keep.nonzero(as_tuple=True)
    it = q[pi]                                       # item of each survivor
    fb = feats.reshape(G * S, SP, F)[fidx[it]]
    u, disc = ray_prim_u(fb, pr[pi, li][:, None, :])
    ok = (disc > 0.0) & (u < -fb[:, :, 12:13])
    gslot = (c[it] * prims.shape[1] + pslot[pi, li])[:, None].expand(-1, SP)
    key = torch.where(ok[..., 0], tw.pack_keys(-u[..., 0], gslot), MISS_KEY)
    lanes = torch.arange(SP)
    item_keys = torch.full((row.shape[0] * SP,), MISS_KEY, dtype=torch.int64)
    item_keys.scatter_reduce_(0, (it[:, None] * SP + lanes).reshape(-1),
                              key.reshape(-1), "amin")
    keys = torch.full((C * G * S * SP,), MISS_KEY, dtype=torch.int64)
    keys.scatter_reduce_(0, (row[:, None] * SP + lanes).reshape(-1),
                         item_keys, "amin")
    keys = keys.reshape(C, G, S, SP)
    nu, s = tw.unpack_keys(keys)
    miss = keys == MISS_KEY
    t = torch.where(miss, _BIG, nu * feats[..., 11])
    s = torch.where(miss, _NOSLOT, s).to(torch.int32)
    return (t.permute(0, 1, 3, 2).contiguous(),
            s.permute(0, 1, 3, 2).contiguous(),
            kept.reshape(C, G, S).to(torch.int32))


@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_cone_split_and_merge_equals_whole_rows(cone_tie, chunk):
    """Bit for bit, for items that split the two copies of the tied sphere
    apart (1 leaf) or keep them together (8), in leaf and group mode, with
    kept summed over items."""
    got = cone_split_merge(cone_tie["feats"], cone_tie["cand"],
                           cone_tie["cones"], *cone_tie["args"], chunk)
    for a, b in zip(got, cone_tie["whole"]):
        assert torch.equal(a, b)
    slot = cone_tie["whole"][1]
    assert (slot < _NOSLOT).float().mean() > 0.3
