"""PyTorch port vs the JAX package: leaf tables, phase A and the tile walk.

``packet_leaf_hit`` and ``subpacket_candidates`` must equal the JAX
functions exactly (rows, counts, overflow), at the default budget and at a
budget of one tile. ``tilecull_call`` on CPU tensors runs
``tilecull_plain``, the plain version of the CUDA kernel ``tilecull_cuda``;
it is held against JAX ``_tilecull_call`` (Pallas, in interpret mode) on
the same candidate rows: slots exactly. The checked driver escalates like
the JAX one, and sentinel prims never hit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tracer_torch as tt
from tests import torch_parity as tp
from tests.torch_parity import one_thread  # noqa: F401
from tracer.core.types import Ray as JRay
from tracer.intersect import cull as jcull
from tracer.kernels import tilecull as jtile
from tracer.kernels.traverse_pallas import pack_bvh as j_pack_bvh
from tracer_torch.intersect import cull as tcull
from tracer_torch.kernels.leafcull import _pad_edge
from tracer_torch.kernels.tilecull import (
    SUBPACKET, nearest_hit_tilecull, nearest_hit_tilecull_checked,
    pack_prim_tiles, pack_ray_features, subpacket_candidates, tilecull_call,
    _NOSLOT)
from tracer_torch.kernels.traverse import pack_bvh

S = 2          # subpackets per packet in these tests


@pytest.fixture(scope="module")
def setup():
    """A 1500-sphere scene, its 16-leaf tree and tables on both sides, and
    1000 direction-sorted rays (origins spread) padded to whole packets."""
    c, r, a = tp.scene_np(1500, seed=21, world=120.0)
    jscene, tscene = tp.scenes(c, r, a)
    jb, tb = tp.bvhs(c, r, 16)
    rng = np.random.default_rng(22)
    d = rng.normal(size=(1000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = rng.uniform(-5, 5, (1000, 3)).astype(np.float32)
    order = np.argsort(tp.np_(tt.kernels.leafcull.octahedral_codes(
        torch.as_tensor(d))), kind="stable")
    o, d = o[order], d[order]
    feats, g, pad = pack_ray_features(torch.as_tensor(o), torch.as_tensor(d),
                                      S)
    op = _pad_edge(torch.as_tensor(o), pad)
    dp = _pad_edge(torch.as_tensor(d), pad)
    return dict(jscene=jscene, tscene=tscene, jb=jb, tb=tb, o=o, d=d,
                feats=feats, op=op, dp=dp,
                jtable=jcull.build_leaf_table(jb),
                table=tcull.build_leaf_table(tb))


def test_leaf_table_and_packet_leaf_hit_match_jax(setup):
    jt, t = setup["jtable"], setup["table"]
    np.testing.assert_array_equal(tp.np_(t.leaf_min), tp.np_(jt.leaf_min))
    np.testing.assert_array_equal(tp.np_(t.leaf_max), tp.np_(jt.leaf_max))
    assert (t.leaf_size, t.num_tiles, t.num_leaves) == (
        jt.leaf_size, jt.num_tiles, jt.num_leaves)
    for packet in (SUBPACKET, tcull.PACKET):
        n = setup["op"].shape[0] // packet * packet
        tb = tcull.packet_bounds(setup["op"][:n], setup["dp"][:n], packet)
        jb = [jnp.asarray(tp.np_(x)) for x in tb]
        np.testing.assert_array_equal(
            tp.np_(tcull.packet_leaf_hit(*tb, t)),
            tp.np_(jcull.packet_leaf_hit(*jb, jt)))
    if n:
        jbounds = jcull.packet_bounds(tp.to_jax(setup["op"][:n]),
                                      tp.to_jax(setup["dp"][:n]))
        for x, y in zip(tcull.packet_bounds(setup["op"][:n],
                                            setup["dp"][:n]), jbounds):
            np.testing.assert_array_equal(tp.np_(x), tp.np_(y))


@pytest.mark.parametrize("k", [64, 1])
def test_subpacket_candidates_match_jax(setup, k):
    cand, ovf = subpacket_candidates(setup["op"], setup["dp"],
                                     setup["table"], k, S)
    jcand, jovf = jtile.subpacket_candidates(
        tp.to_jax(setup["op"]), tp.to_jax(setup["dp"]), setup["jtable"], k,
        S)
    np.testing.assert_array_equal(tp.np_(cand), tp.np_(jcand))
    assert bool(ovf) == bool(jovf)
    assert bool(ovf) == (k == 1)          # both budgets are exercised
    assert int((cand[..., 0] > 0).sum()) > 0


@pytest.fixture(scope="module")
def walk(setup):
    """Rows at the default budget and the walk on both sides."""
    cand, ovf = subpacket_candidates(setup["op"], setup["dp"],
                                     setup["table"], 64, S)
    assert not bool(ovf)
    packed = pack_bvh(setup["tscene"], setup["tb"])
    prims = pack_prim_tiles(packed)
    jpacked = j_pack_bvh(setup["jscene"], setup["jb"])
    jfeats, _, _ = jtile.pack_ray_features(jnp.asarray(setup["o"]),
                                           jnp.asarray(setup["d"]), S)
    jt, js = jtile._tilecull_call(jfeats, tp.to_jax(cand),
                                  jtile.pack_prim_tiles(jpacked), S,
                                  interpret=True)
    t, slot = tilecull_call(setup["feats"], cand, prims)
    return dict(cand=cand, prims=prims, packed=packed, t=t, slot=slot,
                jax=(tp.np_(jt), tp.np_(js)))


def test_prim_tiles_match_jax(setup, walk):
    jtiles = tp.np_(jtile.pack_prim_tiles(
        j_pack_bvh(setup["jscene"], setup["jb"])))       # (T+1, 8, 128)
    tiles = tp.np_(walk["prims"])                          # (T+1, 128, 4)
    P = walk["packed"].prims.shape[0]
    j = jtiles[:, :4].transpose(0, 2, 1).reshape(-1, 4)
    real = np.arange(j.shape[0]) < P
    np.testing.assert_array_equal(tiles.reshape(-1, 4)[real, :3],
                                  j[real, :3])
    np.testing.assert_allclose(tiles.reshape(-1, 4)[real, 3], j[real, 3],
                               rtol=1e-6)
    sent = np.array([0.0, 0.0, 0.0, np.float32(1e30)], np.float32)
    assert (tiles.reshape(-1, 4)[~real] == sent).all()


def test_tilecull_plain_matches_jax_kernel(setup, walk):
    """Slots exactly; t to 1e-5 plus the FMA-rounding margin that
    ``assert_walk_t_close`` allows for rays off the origin."""
    jt, js = walk["jax"]
    slot = tp.np_(walk["slot"])
    np.testing.assert_array_equal(slot, js)
    hit = slot < _NOSLOT
    assert hit.sum() > 30
    t = tp.np_(walk["t"])
    tp.assert_walk_t_close(t, jt, setup["feats"], slot, walk["prims"])
    assert (t[~hit] == np.float32(3e38)).all()


def test_tilecull_slots_match_brute(setup, walk):
    """The tile walk's nearest sphere equals brute force (same u-form
    rounding family; the reference quadratic may flip only at grazes)."""
    G = walk["slot"].shape[0]
    slot = walk["slot"].permute(0, 2, 1).reshape(-1)[:len(setup["o"])]
    hit = slot < _NOSLOT
    pidx = walk["packed"].prim_idx
    sid = torch.where(hit, pidx[torch.where(hit, slot, 0).long()], -1)
    _, ref = tt.brute_t_fast(torch.as_tensor(setup["o"]),
                             torch.as_tensor(setup["d"]),
                             setup["tscene"].centers, setup["tscene"].radii)
    assert G == setup["feats"].shape[0]
    np.testing.assert_array_equal(tp.np_(sid), tp.np_(ref))


def test_checked_driver_escalates_like_jax(setup):
    rays = tt.Ray(origin=torch.as_tensor(setup["o"]),
                  direction=torch.as_tensor(setup["d"]))
    packed = pack_bvh(setup["tscene"], setup["tb"])
    table = setup["table"]
    _, ovf = nearest_hit_tilecull(rays, setup["tscene"], packed, table,
                                  max_candidates=1, subpackets=S)
    assert bool(ovf)
    rec, esc = nearest_hit_tilecull_checked(rays, setup["tscene"], packed,
                                            table, max_candidates=1,
                                            subpackets=S)
    assert esc >= 1
    full, ovf = nearest_hit_tilecull(rays, setup["tscene"], packed, table,
                                     max_candidates=table.num_tiles,
                                     subpackets=S)
    assert not bool(ovf)
    np.testing.assert_array_equal(tp.np_(rec.index), tp.np_(full.index))
    jrec = jtile.nearest_hit_tilecull_checked(
        JRay(origin=jnp.asarray(setup["o"]),
             direction=jnp.asarray(setup["d"])),
        setup["jscene"], j_pack_bvh(setup["jscene"], setup["jb"]),
        setup["jtable"], max_candidates=table.num_tiles, subpackets=S,
        interpret=True)
    np.testing.assert_array_equal(tp.np_(rec.index), tp.np_(jrec.index))
    hit = tp.np_(rec.hit)
    idx = tp.np_(rec.index)[hit]
    tp.assert_sphere_t_close(tp.np_(rec.t)[hit], tp.np_(jrec.t)[hit],
                             setup["o"][hit], setup["d"][hit],
                             tp.np_(setup["tscene"].centers)[idx],
                             tp.np_(setup["tscene"].radii)[idx] ** 2)


def test_sentinels_never_hit():
    """Padded prim slots and the sentinel tile give no hit, also for rays
    aimed straight at the origin (the sentinel's center) and for rays from
    the origin; a row that lists only the sentinel tile is a miss."""
    c, r, a = tp.scene_np(5, seed=9, world=10.0)
    _, tscene = tp.scenes(c, r, a)
    tb = tt.build_bvh(c, r, leaf_size=4, device="cpu")   # sentinel slots
    packed = pack_bvh(tscene, tb)
    table = tcull.build_leaf_table(tb)
    prims = pack_prim_tiles(packed)
    assert float(prims[-1, 0, 3]) == float(np.float32(1e30))
    o = torch.tensor([[5.0, 5.0, 5.0]] * 128 + [[0.0, 0.0, 0.0]] * 128)
    d = torch.nn.functional.normalize(
        torch.cat([-o[:128], torch.randn(128, 3,
                                         generator=torch.Generator()
                                         .manual_seed(0))]), dim=1)
    rays = tt.Ray(origin=o, direction=d)
    rec, _ = nearest_hit_tilecull_checked(rays, tscene, packed, table,
                                          max_candidates=table.num_tiles,
                                          subpackets=1)
    ref = tt.nearest_hit_brute(rays, tscene)
    np.testing.assert_array_equal(tp.np_(rec.index), tp.np_(ref.index))
    feats, _, _ = pack_ray_features(o, d, 1)
    T = table.num_tiles
    cand = torch.full((2, 1, 128), T, dtype=torch.int32)
    cand[:, :, 0] = 1
    t, slot = tilecull_call(feats, cand, prims)
    assert bool((slot == _NOSLOT).all()) and bool((t == 3e38).all())
