"""PyTorch port vs the JAX package: the packet cull (1024-ray packets
against their candidate 128-prim tiles).

``tile_candidates`` must equal the JAX function exactly (candidate lists,
raw counts, overflow) at K = 32 and at K = 1. ``cull_call`` on CPU tensors
runs ``cull_plain``, the plain version of the CUDA kernel ``cull_cuda``; it
is held against JAX ``_cull_packets`` (Pallas, in interpret mode, compiled
once per module) on the same candidates, with no overflow and a ragged
batch: slots exactly, t to 1e-5 relative plus the propagated rounding of
the discriminant (``torch_parity.assert_sphere_t_close``: XLA on the CPU
contracts mul+add into FMA where the port rounds each op). The checked
query escalates from a budget of one tile and equals ``nearest_hit_brute``
by id. Sentinel slots never hit, and the walk stops at min(count, K).

The CUDA kernel splits each 1024-ray packet into eight 128-ray blocks that
share its row, splits the rows into items of at most W listed tiles and
merges each ray's hits by the minimum of a packed (t, listed position)
key (``kernels/tilewalk.py``): the plan is held against an enumeration,
the finalize against a direct mapping, and a model of the split built from
``cull_plain`` must equal the whole-row walk bit for bit, also on a
non-ascending row that lists a tied sphere's two tiles and one tile twice
(the first listed copy wins).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import tracer_torch as tt
from tests import torch_parity as tp
from tests.torch_parity import one_thread  # noqa: F401
from tracer.intersect import cull as jcull
from tracer.kernels.cull_pallas import (_cull_packets as j_cull_packets,
                                        append_sentinel_tile as j_sentinel,
                                        pack_rays as j_pack_rays)
from tracer.kernels.traverse_pallas import pack_bvh as j_pack_bvh
from tracer_torch.core.sort import direction_morton_codes
from tracer_torch.intersect import cull as tcull
from tracer_torch.kernels import _lib
from tracer_torch.kernels import cull as tkcull
from tracer_torch.kernels import tilewalk as tw
from tracer_torch.kernels.leafcull import _pad_edge
from tracer_torch.kernels.traverse import PACKET, pack_bvh, pack_rays

N, LEAF = 2000, 16
B = 2 * PACKET + 37                 # a ragged batch


@pytest.fixture(scope="module")
def setup():
    """A 2000-sphere scene, its 16-leaf tree, leaf tables and packed tables
    on both sides, and B direction-sorted rays with spread origins, packed
    and edge-padded to whole packets."""
    c, r, a = tp.scene_np(N, seed=31, world=120.0)
    jscene, tscene = tp.scenes(c, r, a)
    jb, tb = tp.bvhs(c, r, LEAF)
    rng = np.random.default_rng(32)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = rng.uniform(-30, 30, (B, 3)).astype(np.float32)
    order = np.argsort(tp.np_(direction_morton_codes(torch.as_tensor(d))),
                       kind="stable")
    o, d = torch.as_tensor(o[order]), torch.as_tensor(d[order])
    prays, g, pad = pack_rays(o, d)
    table = tcull.build_leaf_table(tb)
    jtable = jcull.build_leaf_table(jb)
    np.testing.assert_array_equal(tp.np_(table.leaf_min),
                                  tp.np_(jtable.leaf_min))
    assert (table.num_tiles, table.num_leaves) == (jtable.num_tiles,
                                                   jtable.num_leaves)
    packed = pack_bvh(tscene, tb)
    return dict(jscene=jscene, tscene=tscene, jb=jb, tb=tb, o=o, d=d,
                op=_pad_edge(o, pad), dp=_pad_edge(d, pad), prays=prays,
                table=table, jtable=jtable, packed=packed,
                tiles=tkcull.cull_tiles(packed, table.num_tiles))


@pytest.mark.parametrize("K", [32, 1])
def test_tile_candidates_match_jax(setup, K):
    cand, counts, ovf = tt.tile_candidates(setup["op"], setup["dp"],
                                           setup["table"], K)
    jc, jn, jovf = jcull.tile_candidates(tp.to_jax(setup["op"]),
                                         tp.to_jax(setup["dp"]),
                                         setup["jtable"], K)
    assert cand.dtype == counts.dtype == torch.int32
    np.testing.assert_array_equal(tp.np_(cand), tp.np_(jc))
    np.testing.assert_array_equal(tp.np_(counts), tp.np_(jn))
    assert bool(ovf) == bool(jovf) == (K == 1)
    assert (tp.np_(counts) > 1).all()


@pytest.fixture(scope="module")
def jax_cull(setup):
    """JAX _cull_packets (interpret mode) on the port's candidates at the
    full budget: (cand, counts, t, idx)."""
    T = setup["table"].num_tiles
    cand, counts, ovf = tt.tile_candidates(setup["op"], setup["dp"],
                                           setup["table"], T)
    assert not bool(ovf)
    jpacked = j_pack_bvh(setup["jscene"], setup["jb"])
    jrays, _, _ = j_pack_rays(tp.to_jax(setup["o"]), tp.to_jax(setup["d"]))
    t, idx = j_cull_packets(jrays, j_sentinel(jpacked.prims),
                            tp.to_jax(cand), tp.to_jax(counts),
                            interpret=True)
    return cand, counts, tp.np_(t).reshape(-1, PACKET), \
        tp.np_(idx).reshape(-1, PACKET)


def test_cull_call_matches_jax(setup, jax_cull):
    cand, counts, jt, jidx = jax_cull
    t, slot = tt.cull_call(setup["prays"], setup["tiles"], cand, counts)
    assert slot.dtype == torch.int32 and tuple(slot.shape) == jidx.shape
    np.testing.assert_array_equal(tp.np_(slot), jidx)
    hit = jidx >= 0
    assert hit.any() and not hit.all()
    assert np.isinf(tp.np_(t)[~hit]).all()
    q = tp.np_(setup["packed"].prims)[jidx[hit]]
    rays = tp.np_(setup["prays"])[hit]
    tp.assert_sphere_t_close(tp.np_(t)[hit], jt[hit], rays[:, 0:3],
                             rays[:, 3:6], q[:, 0:3], q[:, 3], rtol=1e-5)


def test_cull_checked_escalates_and_equals_brute(setup):
    rays = tt.Ray(origin=setup["o"], direction=setup["d"])
    table, packed = setup["table"], setup["packed"]
    _, ovf = tt.nearest_hit_cull(rays, setup["tscene"], packed, table, 1)
    assert bool(ovf)
    rec, esc = tt.nearest_hit_cull_checked(rays, setup["tscene"], packed,
                                           table, max_candidates=1)
    assert esc >= 1
    ref = tt.nearest_hit_brute(rays, setup["tscene"])
    np.testing.assert_array_equal(tp.np_(rec.index), tp.np_(ref.index))
    assert (tp.np_(ref.index) >= 0).any()
    # A 2-D batch keeps its shape.
    rec2, _ = tt.nearest_hit_cull_checked(
        tt.Ray(origin=setup["o"][:2048].reshape(32, 64, 3),
               direction=setup["d"][:2048].reshape(32, 64, 3)),
        setup["tscene"], packed, table)
    assert tuple(rec2.index.shape) == (32, 64)
    np.testing.assert_array_equal(tp.np_(rec2.index).reshape(-1),
                                  tp.np_(rec.index)[:2048])


def test_sentinel_tile_and_tail_slots_never_hit(setup):
    tiles, packed, table = setup["tiles"], setup["packed"], setup["table"]
    T = table.num_tiles
    n = packed.prims.shape[0]
    assert tiles.shape == (T + 1, 128, 4) and n < T * 128
    flat = tiles.reshape(-1, 4)
    assert (flat[n:, 3] == -1e30).all() and (flat[n:, :3] == 0).all()
    # Rays from the scene's middle and from far off, along the axes and the
    # diagonals, against the sentinel tile and the last (partly filled)
    # tile only: no slot past the packed prims may win.
    dirs = torch.tensor([[1, 1, 1], [-1, -1, -1], [1, 0, 0], [0, -1, 0],
                         [0, 0, 1], [1, -1, 1]], dtype=torch.float32)
    dirs = dirs / dirs.norm(dim=1, keepdim=True)
    origins = torch.tensor([[0, 0, 0], [1e3, -1e3, 5e2], [-30, 20, 10]],
                           dtype=torch.float32)
    o = origins.repeat_interleave(dirs.shape[0], 0).repeat(57, 1)
    d = dirs.repeat(origins.shape[0], 1).repeat(57, 1)
    prays, g, _ = pack_rays(o, d)
    cand = torch.tensor([[T, T - 1]], dtype=torch.int32).repeat(g, 1)
    counts = torch.full((g, 1), 2, dtype=torch.int32)
    _, slot = tt.cull_call(prays, tiles, cand, counts)
    assert (slot < n).all()
    only_sentinel = torch.full((g, 1), T, dtype=torch.int32)
    t, slot = tt.cull_call(prays, tiles, only_sentinel, counts[:, :1] // 2)
    assert (slot == -1).all() and torch.isinf(t).all()
    # Listing the sentinel tile after each packet's own tiles changes
    # nothing.
    cand, counts, _ = tt.tile_candidates(setup["op"], setup["dp"], table, T)
    listed = torch.cat([cand, torch.full_like(cand[:, :1], T)], dim=1)
    want = tt.cull_call(setup["prays"], tiles, cand, counts)
    got = tt.cull_call(setup["prays"], tiles, listed, counts + 1)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_walk_stops_at_min_count_and_budget(setup):
    """On an overflowing call (raw counts > K) every hit comes from the
    first K listed tiles, as if the counts were clamped to K."""
    K = 3
    cand, counts, ovf = tt.tile_candidates(setup["op"], setup["dp"],
                                           setup["table"], K)
    assert bool(ovf) and (counts > K).any()
    t, slot = tt.cull_call(setup["prays"], setup["tiles"], cand, counts)
    hit = slot >= 0
    assert hit.any()
    tile = torch.where(hit, slot // 128, cand[:, :1])
    assert (tile[:, :, None] == cand[:, None, :]).any(dim=2).all()
    t2, slot2 = tt.cull_call(setup["prays"], setup["tiles"], cand,
                             counts.clamp(max=K))
    assert torch.equal(slot, slot2) and torch.equal(t, t2)


def test_cull_plain_slicing_and_wrappers(setup):
    _lib.launches.clear()
    T = setup["table"].num_tiles
    cand, counts, _ = tt.tile_candidates(setup["op"], setup["dp"],
                                         setup["table"], T)
    args = (setup["prays"], setup["tiles"], cand, counts)
    whole = tkcull.cull_plain(*args)
    sliced = tkcull.cull_plain(*args, pair_elems=3 * PACKET * 128)
    assert all(torch.equal(x, y) for x, y in zip(whole, sliced))
    assert all(torch.equal(x, y) for x, y in zip(tt.cull_call(*args), whole))
    with pytest.raises(ValueError, match="CUDA"):
        tt.cull_call(*(x.to("meta") for x in args))
    with pytest.raises(ValueError, match="CUDA"):
        tkcull.cull_cuda(*args)
    with pytest.raises(ValueError, match="counts"):
        tt.cull_call(setup["prays"], setup["tiles"], cand, counts[:1])
    assert not _lib.launches


# -- the split walk: item plan, packed keys, split-and-merge model ----------

def test_keys_map_positions_back_to_slots():
    """A merged key holds (t, listed position * 128 + lane); the finalize
    maps the position through the packet's row, in any listed order, and
    the miss key (+inf, 2^32 - 1) becomes (+inf, -1)."""
    cand = torch.tensor([[7, 2, 5], [4, 4, 0]], dtype=torch.int32)
    t = torch.full((2, PACKET), 2.5)
    idx = torch.arange(2 * PACKET).reshape(2, PACKET) % 384
    keys = tw.pack_keys(t, idx)
    keys[1, 100:] = tkcull.MISS_KEY
    tt_, slot = tkcull.slots_from_keys(keys, cand)
    want = cand.long().gather(1, idx // 128) * 128 + idx % 128
    assert torch.equal(slot[0], want[0].to(torch.int32))
    assert torch.equal(slot[1, :100], want[1, :100].to(torch.int32))
    assert (slot[1, 100:] == -1).all() and torch.isinf(tt_[1, 100:]).all()
    assert (tt_[:, :100] == 2.5).all()
    top = np.nextafter(np.float32(np.inf), np.float32(0))
    assert int(tw.pack_keys(torch.tensor(top), torch.tensor(2 ** 32 - 1))) \
        < tkcull.MISS_KEY
    tm, im = tw.unpack_keys(torch.tensor(tkcull.MISS_KEY))
    assert np.isinf(float(tm)) and int(im) == 2 ** 32 - 1


@pytest.mark.parametrize("counts,K,chunk", [
    ([0, 40, 10, 3], 10, 4),          # count 0, count > K, K not a multiple
    ([13, 0, 0], 13, 8),              # one packet lists every tile
    ([-1, 5], 7, 16)])                # a negative count, one partial item
def test_cull_item_plan_matches_enumeration(counts, K, chunk):
    walked = tkcull.walked_tiles(torch.tensor(counts, dtype=torch.int32)
                                 .reshape(-1, 1), K)
    want = np.repeat(np.clip(counts, 0, K), tkcull.BLOCKS)
    np.testing.assert_array_equal(walked.numpy(), want)
    starts = tw.plan_items(walked, chunk)
    items = tp.np_items(want, chunk)
    assert int(starts[-1]) == len(items)
    got = np.stack([x.numpy() for x in tw.item_table(starts, walked, chunk)],
                   1).reshape(-1, 3)
    np.testing.assert_array_equal(got, items)


@pytest.fixture(scope="module")
def tie_cull():
    """Six tiles of spheres (one stored twice, tiles 1 and 3), three
    1024-ray packets, K = 9, and rows: none; every tile and the sentinel;
    a non-ascending row that lists tiles 3 and 1 twice, raw count 12 > K."""
    c, r, o, d = tp.tie_tiles_np(6, 3 * PACKET, seed=43)
    packed = SimpleNamespace(prims=torch.as_tensor(
        np.concatenate([c, (r * r)[:, None]], 1)))
    tiles = tkcull.cull_tiles(packed, 6)
    rays, g, _ = pack_rays(torch.as_tensor(o), torch.as_tensor(d))
    T = 6
    cand = torch.tensor([[T] * 9, list(range(T + 1)) + [T, T],
                         [3, 0, 1, 5, 2, 4, T, 3, 1]], dtype=torch.int32)
    counts = torch.tensor([[0], [7], [12]], dtype=torch.int32)
    return rays, tiles, cand, counts, tt.cull_call(rays, tiles, cand, counts)


def cull_split_merge(rays, tiles, cand, counts, chunk):
    """The kernel's split walk modelled with the plain walk: each item's
    sub-row walked by cull_plain on its packet, its block's 128 rays kept,
    the slot turned into the row's first listed position of that tile, the
    keys merged by min and mapped back as the wrapper does."""
    g, K = cand.shape
    T = tiles.shape[0] - 1
    walked = tkcull.walked_tiles(counts, K)
    row, first, n = tw.item_table(tw.plan_items(walked, chunk), walked, chunk)
    p, blk = row // tkcull.BLOCKS, row % tkcull.BLOCKS
    j = torch.arange(chunk)
    sub = torch.where(j < n[:, None],
                      cand[p[:, None], (first[:, None] + j).clamp(max=K - 1)],
                      T)
    t, slot = tkcull.cull_plain(rays[p], tiles, sub.to(torch.int32),
                                n[:, None].to(torch.int32))
    lanes = blk[:, None] * 128 + torch.arange(128)
    t, slot = t.gather(1, lanes), slot.gather(1, lanes).long()
    kk = (sub[:, None, :] == (slot // 128)[:, :, None]).int().argmax(2)
    key = torch.where(slot >= 0, tw.pack_keys(
        t, (first[:, None] + kk) * 128 + slot % 128), tkcull.MISS_KEY)
    keys = torch.full((g * PACKET,), tkcull.MISS_KEY, dtype=torch.int64)
    keys.scatter_reduce_(0, (row[:, None] * 128 + torch.arange(128))
                         .reshape(-1), key.reshape(-1), "amin")
    return tkcull.slots_from_keys(keys.reshape(g, PACKET), cand)


@pytest.mark.parametrize("chunk", [1, 4, 8])
def test_cull_split_and_merge_equals_whole_rows(tie_cull, chunk):
    """Bit for bit; the first listed copy of the tied sphere wins (tile 3
    before tile 1 in the non-ascending row), whether the items split the
    copies apart or not."""
    rays, tiles, cand, counts, (t, slot) = tie_cull
    got = cull_split_merge(rays, tiles, cand, counts, chunk)
    assert torch.equal(got[0], t) and torch.equal(got[1], slot)
    assert (slot[0] == -1).all()
    assert (slot[1] == tp.DUP[0]).sum() > 5 and (slot[2] == tp.DUP[1]).sum() > 5
    assert not (slot[1] == tp.DUP[1]).any() and not (slot[2] == tp.DUP[0]).any()
