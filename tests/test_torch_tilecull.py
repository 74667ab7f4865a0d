"""PyTorch port vs the JAX package: leaf tables, phase A and the tile walk.

``packet_leaf_hit`` and ``subpacket_candidates`` must equal the JAX
functions exactly (rows, counts, overflow), at the default budget and at a
budget of one tile. ``tilecull_call`` on CPU tensors runs
``tilecull_plain``, the plain version of the CUDA kernel ``tilecull_cuda``;
it is held against JAX ``_tilecull_call`` (Pallas, in interpret mode) on
the same candidate rows: slots exactly. The checked driver escalates like
the JAX one, and sentinel prims never hit.

The CUDA kernel splits each row into items of at most W listed tiles and
merges each ray's hits by the minimum of a packed (t, slot) key
(``kernels/tilewalk.py``). The item plan is held against an enumeration,
the keys' order and miss sentinel are checked, and a model of the split
built from ``tilecull_plain`` (each item's sub-row walked alone, the keys
merged by min) must equal the whole-row walk bit for bit, also where one
sphere is stored in two tiles (an exact t tie: the lowest slot wins).
"""

from types import SimpleNamespace

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
from tracer_torch.kernels import tilecull as tkcull
from tracer_torch.kernels import tilewalk as tw
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
    # The port's tiles hold r^2 where JAX's hold |c|^2 - r^2.
    np.testing.assert_array_equal(tiles.reshape(-1, 4)[real, 3],
                                  tp.np_(walk["packed"].prims)[:, 3])
    np.testing.assert_allclose(
        tp.np_(tp.jax_prims(tiles)).reshape(-1, 4)[real, 3], j[real, 3],
        rtol=1e-6)
    sent = np.array([0.0, 0.0, 0.0, np.float32(-1e30)], np.float32)
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
    assert float(prims[-1, 0, 3]) == float(np.float32(-1e30))
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


# -- the split walk: item plan, packed keys, split-and-merge model ----------

def test_keys_round_trip_and_order():
    """pack/unpack are inverse, the minimum key is the smallest t and then
    the lowest index, and the tile walk's miss key is (3e38, 2^30), above
    every accepted key."""
    rng = np.random.default_rng(5)
    t = rng.choice(np.float32([1e-6, 0.5, 0.5000001, 3.0, 7e37, 2.9e38]),
                   4000)
    idx = rng.integers(0, 2 ** 32, 4000)
    idx[:4] = [0, 2 ** 30, 2 ** 32 - 1, 1]
    keys = tw.pack_keys(torch.as_tensor(t), torch.as_tensor(idx))
    tk, ik = tw.unpack_keys(keys)
    np.testing.assert_array_equal(tk.numpy().view(np.uint32),
                                  t.view(np.uint32))
    np.testing.assert_array_equal(ik.numpy(), idx)
    order = np.lexsort((idx, t))                        # t, then idx
    np.testing.assert_array_equal(np.sort(keys.numpy()), keys.numpy()[order])
    tm, im = tw.unpack_keys(keys.min())
    assert float(tm) == t.min() and int(im) == idx[t == t.min()].min()
    tm, im = tw.unpack_keys(torch.tensor(tkcull.MISS_KEY))
    assert float(tm) == np.float32(3e38) and int(im) == _NOSLOT
    below = np.nextafter(np.float32(3e38), np.float32(0))
    assert int(tw.pack_keys(torch.tensor(below), torch.tensor(_NOSLOT - 1))) \
        < tkcull.MISS_KEY


@pytest.mark.parametrize("counts,chunk", [
    ([0, 5, 8, 9, 17, 0, 1, 127], 8),        # ragged, K = 127 not a multiple
    ([300, 3, -2, 0], 4),                    # a count past Kp - 1, a negative
    ([0, 0, 0, 0, 0, 0, 0, 127], 16),        # one row lists every tile
    ([0, 0, 0, 0], 4)])                      # nothing to walk
def test_item_plan_matches_enumeration(counts, chunk):
    cand = torch.zeros((len(counts) // 2, 2, 128), dtype=torch.int32)
    cand.view(-1, 128)[:, 0] = torch.tensor(counts, dtype=torch.int32)
    walked = tkcull.walked_tiles(cand)
    want = np.clip(counts, 0, 127)
    np.testing.assert_array_equal(walked.numpy(), want)
    starts = tw.plan_items(walked, chunk)
    items = tp.np_items(want, chunk)
    assert starts.dtype == torch.int32 and int(starts[-1]) == len(items)
    np.testing.assert_array_equal(
        starts[:-1].numpy(), np.searchsorted(items[:, 0], np.arange(
            len(counts))))
    got = np.stack([x.numpy() for x in tw.item_table(starts, walked, chunk)],
                   1).reshape(-1, 3)
    np.testing.assert_array_equal(got, items)


@pytest.fixture(scope="module")
def tie_walk():
    """Six tiles of spheres (one stored twice, tiles 1 and 3), 768 rays in
    3 x 2 subpackets, and rows: none, every tile and the sentinel, both
    copies, a non-ascending row, the sentinel between tiles, every tile."""
    c, r, o, d = tp.tie_tiles_np(6, 768, seed=41)
    prims = pack_prim_tiles(SimpleNamespace(prims=torch.as_tensor(
        np.concatenate([c, (r * r)[:, None]], 1))))
    T = prims.shape[0] - 1
    feats, _, _ = pack_ray_features(torch.as_tensor(o), torch.as_tensor(d), 2)
    lists = [[], list(range(T + 1)), [1, 3], [3, 0, 1, 5], [2, T, 4],
             list(range(T))]
    cand = torch.full((6, 128), T, dtype=torch.int32)
    for i, row in enumerate(lists):
        cand[i, 0] = len(row)
        cand[i, 1:1 + len(row)] = torch.tensor(row, dtype=torch.int32)
    cand = cand.reshape(3, 2, 128)
    return feats, cand, prims, tilecull_call(feats, cand, prims)


def split_merge(feats, cand, prims, chunk):
    """The kernel's split walk modelled with the plain walk: each item's
    sub-row walked by tilecull_plain as a one-subpacket row of its own, the
    results merged into the keys by min, then unpacked as the wrapper
    does."""
    G, S, SP, F = feats.shape
    kp, T = cand.shape[-1], prims.shape[0] - 1
    rows = cand.reshape(-1, kp)
    walked = tkcull.walked_tiles(cand)
    row, first, n = tw.item_table(tw.plan_items(walked, chunk), walked, chunk)
    j = torch.arange(chunk)
    cols = (1 + first[:, None] + j).clamp(max=kp - 1)
    sub = torch.where(j < n[:, None], rows[row[:, None], cols], T)
    sub = torch.cat([n[:, None], sub], 1).to(torch.int32)[:, None]
    t, slot = tkcull.tilecull_plain(feats.reshape(-1, 1, SP, F)[row], sub,
                                    prims)
    keys = torch.full((G * S * SP,), tkcull.MISS_KEY, dtype=torch.int64)
    dest = (row[:, None] * SP + torch.arange(SP)).reshape(-1)
    keys.scatter_reduce_(0, dest, tw.pack_keys(t.reshape(-1),
                                               slot.reshape(-1)), "amin")
    return tkcull.results_from_keys(keys, G, S)


@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_split_and_merge_equals_whole_rows(tie_walk, chunk):
    """Bit for bit, for items that split the two copies of the tied sphere
    apart (chunk 1) or keep them together (8)."""
    feats, cand, prims, (t, slot) = tie_walk
    got = split_merge(feats, cand, prims, chunk)
    assert torch.equal(got[0], t) and torch.equal(got[1], slot)
    slot = slot.permute(0, 2, 1).reshape(6, 128)
    assert (slot[0] == _NOSLOT).all()                  # the empty row
    for i in (1, 2, 3, 5):                             # both copies listed
        assert (slot[i] == tp.DUP[0]).sum() > 5
        assert not (slot[i] == tp.DUP[1]).any()
    assert (slot < _NOSLOT).float().mean() > 0.5
