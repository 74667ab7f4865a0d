"""PyTorch port vs the JAX package: the closest-hit leaf walk.

``leafcull_call`` on CPU tensors runs ``leafcull_plain``, the plain version
of the CUDA kernel. It is held against JAX ``_leafcull_call`` (Pallas, in
interpret mode) on the SAME feature planes and candidate rows: slots
exactly, t to 1e-5 relative. Cases cover leaf sizes 8 and 32, group-mode
rows and C > 1 chunks (the min-merge). Synthetic cases pin the tie-break
rules, and a walk over every group is held against brute force.

The CUDA kernel splits each row's walked leaves into items and merges each
ray's best by the minimum of a packed (-u, slot) key. The item plan is held
against an enumeration, the keys' order (on u, not t) is checked, and a
model of the split built from the plain walk (each item's leaves walked as
a row of their own, the keys merged by min) must equal the whole-row walk
bit for bit, where one sphere is stored twice (an exact u tie) and in
group mode.
"""

import numpy as np
import pytest
import torch

import tracer_torch as tt
from tests import torch_parity as tp
from tests.torch_parity import one_thread  # noqa: F401
from tracer.kernels import conecull as jcone
from tracer.kernels.leafcull import _leafcull_call as j_leafcull_call
from tracer_torch.kernels import tilewalk as tw
from tracer_torch.kernels.leafcull import (
    MISS_KEY, closest_rows_u, item_leaves, leafcull_plain, pack_ray_features,
    walked_leaves, _walk_pairs, _BIG, _NOSLOT)

# case -> (spheres, leaf size, max_candidates, max_chunk_bytes)
CASES = {
    "ls8": (500, 8, 119, 9 << 20),
    "ls32": (900, 32, 119, 9 << 20),
    "ls8_group_mode": (700, 8, 7, 9 << 20),
    "ls8_chunked": (700, 8, 119, 80 * 1024),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """Port tables, features and rows, and the JAX walk's (t, slot) on the
    same features and rows (computed once per case)."""
    n, ls, mc, chunk_bytes = CASES[request.param]
    c, r, a = tp.scene_np(n, seed=3)
    jscene, tscene = tp.scenes(c, r, a)
    jb, tb = tp.bvhs(c, r, ls)
    jt = jcone.build_cone_tables(jscene, jb, max_chunk_bytes=chunk_bytes)
    t = tt.build_cone_tables(tscene, tb, max_chunk_bytes=chunk_bytes)
    o, d = tp.origin_rays_np(1024)
    feats, dest = tt.prep_feats_bucketed(torch.as_tensor(o),
                                         torch.as_tensor(d), tp.S, tp.SP,
                                         cell_bits=tp.CELL_BITS)
    rows, _, ovf = tt.cone_candidates(feats, t, 64, mc)
    assert not bool(ovf)
    cull = t.cull
    rows = rows.reshape(cull.num_chunks, feats.shape[0], tp.S, -1)
    jt_k, js_k = j_leafcull_call(
        tp.jfeats(feats), tp.to_jax(rows), jt.cull.entries, tp.S, tp.SP,
        cull.leaf_size, cull.leaves_per_chunk, cull.leaves_per_group,
        interpret=True)
    return dict(name=request.param, scene=tscene, tables=t, feats=feats,
                rows=rows, dest=dest, rays=(o, d),
                jax=(tp.np_(jt_k), tp.np_(js_k)))


def _walk_args(case):
    cull = case["tables"].cull
    return (case["feats"], case["rows"], cull.prims, cull.leaf_size,
            cull.leaves_per_chunk, cull.leaves_per_group)


def test_leafcull_call_matches_jax(case):
    t, slot = tt.leafcull_call(*_walk_args(case))
    jt, js = case["jax"]
    assert tuple(t.shape) == jt.shape and slot.dtype == torch.int32
    np.testing.assert_array_equal(tp.np_(slot), js)
    hit = js < _NOSLOT
    assert hit.any() and not hit.all()
    tp.assert_walk_t_close(t, jt, case["feats"], slot,
                           case["tables"].cull.prims, rtol=1e-5)
    rows = tp.np_(case["rows"])
    if case["name"] == "ls8_group_mode":
        assert (rows[..., 0] < 0).any()
    if case["name"] == "ls8_chunked":
        assert rows.shape[0] > 1


def test_leafcull_plain_slicing_does_not_change_results(case):
    """Slices of about a sixth of the walked (row, leaf) pairs each: many
    slices, each merged into rows that earlier slices already hold."""
    cull = case["tables"].cull
    rows = case["rows"]
    pairs = _walk_pairs(rows.reshape(-1, rows.shape[-1]),
                        cull.leaves_per_group)[0].shape[0]
    step = pairs // 6 + 1
    assert pairs > 2 * step
    t1, s1 = leafcull_plain(*_walk_args(case))
    t2, s2 = leafcull_plain(*_walk_args(case),
                            pair_elems=step * tp.SP * cull.leaf_size)
    assert torch.equal(s1, s2)
    hit = s1 < _NOSLOT
    assert torch.equal(t1[hit], t2[hit])
    assert (t1[~hit] == _BIG).all()


def test_walk_over_every_group_equals_brute(case):
    """Rows that list every group (group mode) make the walk exhaustive:
    it must then agree with the brute-force oracle on every ray."""
    tables = case["tables"]
    cull = tables.cull
    C, G, S, rowlen = case["rows"].shape
    gpc = cull.leaves_per_chunk // cull.leaves_per_group
    assert gpc <= rowlen - 1, "rows too short to list every group"
    rows = torch.full((C, G, S, rowlen), cull.leaves_per_chunk,
                      dtype=torch.int32)
    rows[..., 0] = -gpc
    rows[..., 1:1 + gpc] = torch.arange(gpc, dtype=torch.int32)
    t, slot = tt.leafcull_call(case["feats"], rows, cull.prims,
                               cull.leaf_size, cull.leaves_per_chunk,
                               cull.leaves_per_group)
    k = tt.kernel_order_dest(case["dest"], tp.S, tp.SP)
    s = slot.reshape(-1)[k]
    sid = torch.where(s < _NOSLOT,
                      cull.slot_to_sphere[s.clamp(max=len(cull.slot_to_sphere)
                                                  - 1)], -1)
    o, d = (torch.as_tensor(x) for x in case["rays"])
    bt, bi = tt.brute_t_fast(o, d, case["scene"].centers, case["scene"].radii)
    np.testing.assert_array_equal(tp.np_(sid), tp.np_(bi))
    ok = tp.np_(bi) >= 0
    np.testing.assert_allclose(tp.np_(t.reshape(-1)[k])[ok], tp.np_(bt)[ok],
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# synthetic tie-break and merge rules
# ---------------------------------------------------------------------------

LS, SP = 4, 64


def _one_ray_feats():
    o = torch.zeros((SP, 3))
    d = torch.tensor([[1.0, 0.0, 0.0]]).repeat(SP, 1)
    feats, _, _ = pack_ray_features(o, d, 1, SP)
    return feats                                     # (1, 1, SP, FEAT)


def _prims(chunks):
    """chunks: list of per-chunk lists of (slot, center x, radius)."""
    lpc = 2
    p = torch.zeros((len(chunks), lpc * LS, 4))
    p[..., 3] = -1e30                                 # sentinel slots
    for ci, spheres in enumerate(chunks):
        for slot, x, r in spheres:
            p[ci, slot] = torch.tensor([x, 0.0, 0.0, r * r])
    return p


def _rows(per_chunk):
    rows = torch.full((len(per_chunk), 1, 1, 8), 2, dtype=torch.int32)
    for ci, ids in enumerate(per_chunk):
        rows[ci, 0, 0, 0] = len(ids) if ids else 0
        rows[ci, 0, 0, 1:1 + len(ids)] = torch.tensor(ids, dtype=torch.int32)
    return rows


def test_equal_hits_in_one_chunk_take_the_lowest_slot():
    # The same sphere in leaf 0 (slot 3) and leaf 1 (slot 5), listed with
    # leaf 1 first: the lower slot wins.
    prims = _prims([[(3, 10.0, 1.0), (5, 10.0, 1.0)]])
    t, slot = tt.leafcull_call(_one_ray_feats(), _rows([[1, 0]]), prims,
                               LS, 2, 16)
    assert (slot == 3).all()
    torch.testing.assert_close(t, torch.full_like(t, 9.0))


def test_chunks_merge_by_t_then_lowest_chunk():
    feats = _one_ray_feats()
    tie = _prims([[(1, 10.0, 1.0)], [(1, 10.0, 1.0)]])
    t, slot = tt.leafcull_call(feats, _rows([[0], [0]]), tie, LS, 2, 16)
    assert (slot == 1).all()                        # chunk 0 wins the tie
    nearer = _prims([[(1, 10.0, 1.0)], [(2, 6.0, 1.0)]])
    t, slot = tt.leafcull_call(feats, _rows([[0], [0]]), nearer, LS, 2, 16)
    assert (slot == 2 * LS + 2).all()               # chunk 1's nearer hit
    torch.testing.assert_close(t, torch.full_like(t, 5.0))


def test_empty_rows_and_misses_write_no_hit():
    feats = _one_ray_feats()
    prims = _prims([[(1, 10.0, 1.0)], [(0, 0.0, 1.0), (2, -8.0, 1.0)]])
    # chunk 0: empty row; chunk 1: a sphere around the origin (the near
    # root is behind the ray) and one behind it.
    t_c, s_c = leafcull_plain(feats, _rows([[], [0]]), prims, LS, 2, 16)
    assert (s_c == _NOSLOT).all() and (t_c == _BIG).all()
    t, slot = tt.leafcull_call(feats, _rows([[], [0]]), prims, LS, 2, 16)
    assert (slot == _NOSLOT).all()


# ---------------------------------------------------------------------------
# the split walk: item plan, (-u, slot) keys, split-and-merge model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("counts,lpg,chunk", [
    ([3, 1, 0, 7, 2, 9, 4, 1], 16, 2),           # leaf mode
    ([-1, -3, 2, -2, 0, 5, -1, 1], 4, 3),        # group mode beside leaf mode
    ([0] * 8, 16, 4),                            # nothing to walk
    ([5, -2, 0, 1, 0, 3, -1, 8] * 2, 2, 4)])     # C = 2 chunks
def test_leaf_item_plan_matches_enumeration(counts, lpg, chunk):
    cand = torch.zeros((len(counts) // 8, 2, 4, 12), dtype=torch.int32)
    cand.view(-1, 12)[:, 0] = torch.tensor(counts, dtype=torch.int32)
    want = np.array([c if c > 0 else -c * lpg for c in counts])
    walked = walked_leaves(cand, lpg)
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
    assert (item_leaves(32), item_leaves(16), item_leaves(4)) == (4, 8, 32)


def test_u_keys_round_trip_and_order():
    """(-u, slot) keys: pack/unpack are inverse, the minimum is the largest
    u and then the lowest slot, and the miss key is above every hit key.
    Two u that round to one t = (-u) * (1/a) still order by u, where a key
    on t would take the lower slot."""
    rng = np.random.default_rng(6)
    u = -rng.choice(np.float32([1e-6, 0.5, 0.5000001, 3.0, 7e37, 3.4e38]),
                    4000)
    slot = rng.integers(0, 2 ** 30, 4000)
    slot[:3] = [0, 2 ** 30 - 1, 1]
    keys = tw.pack_keys(torch.as_tensor(-u), torch.as_tensor(slot))
    nu, s = tw.unpack_keys(keys)
    np.testing.assert_array_equal((-nu).numpy().view(np.uint32),
                                  u.view(np.uint32))
    np.testing.assert_array_equal(s.numpy(), slot)
    order = np.lexsort((slot, -u))                  # largest u, then slot
    np.testing.assert_array_equal(np.sort(keys.numpy()), keys.numpy()[order])
    assert int(keys.max()) < MISS_KEY
    inva = np.float32(1.0) / np.float32(3.0)
    far = next(x for x in -(np.float32(10.0) + np.arange(1000, dtype=np.float32)
                            * np.float32(0.37))
               if np.float32(-x) * inva
               == np.float32(-np.nextafter(x, np.float32(0))) * inva)
    near = np.nextafter(far, np.float32(0))         # the larger u
    pair = torch.tensor([far, near])
    slots = torch.tensor([2, 9])
    _, best = tw.unpack_keys(tw.pack_keys(-pair, slots).min())
    assert int(best) == 9
    t = -pair * torch.tensor(inva)
    assert t[0] == t[1]
    _, by_t = tw.unpack_keys(tw.pack_keys(t, slots).min())
    assert int(by_t) == 2


@pytest.fixture(scope="module")
def tie_leaf_walk():
    feats, cand, prims, ls, lpc, lpg = tp.tie_leaves(43)
    return (feats, cand, prims, ls, lpg,
            leafcull_plain(feats, cand, prims, ls, lpc, lpg))


def split_merge(feats, cand, prims, ls, lpg, chunk):
    """The kernel's split walk modelled with the plain walk: each item's
    leaves walked by closest_rows_u as a row of their own, each ray's
    (-u, slot) key min-merged over the items, then unpacked as the kernel's
    epilogue does: t = (-u) * (1/a), (3e38, 2^30) for a miss."""
    G, S, SP, F = feats.shape
    C = cand.shape[0]
    row, sub = tp.leaf_item_rows(cand, lpg, chunk)
    u, slot = closest_rows_u(feats.reshape(G * S, SP, F), row % (G * S),
                             row // (G * S), sub, prims, ls, lpg)
    key = torch.where(slot < _NOSLOT, tw.pack_keys(-u, slot), MISS_KEY)
    keys = torch.full((C * G * S * SP,), MISS_KEY, dtype=torch.int64)
    keys.scatter_reduce_(0, (row[:, None] * SP + torch.arange(SP)).reshape(-1),
                         key.reshape(-1), "amin")
    keys = keys.reshape(C, G, S, SP)
    nu, s = tw.unpack_keys(keys)
    miss = keys == MISS_KEY
    t = torch.where(miss, _BIG, nu * feats[..., 11])
    s = torch.where(miss, _NOSLOT, s).to(torch.int32)
    return (t.permute(0, 1, 3, 2).contiguous(),
            s.permute(0, 1, 3, 2).contiguous())


@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_split_and_merge_equals_whole_rows(tie_leaf_walk, chunk):
    """Bit for bit, for items that split the two copies of the tied sphere
    apart (1 leaf) or keep them together (8), in leaf and group mode."""
    feats, cand, prims, ls, lpg, (t, slot) = tie_leaf_walk
    got = split_merge(feats, cand, prims, ls, lpg, chunk)
    assert torch.equal(got[0], t) and torch.equal(got[1], slot)
    assert (slot == tp.LEAF_DUP[0]).sum() > 5
    assert not (slot == tp.LEAF_DUP[1]).any()
    assert (slot[0, 0, :, 0] == _NOSLOT).all()            # the empty row
    assert (slot < _NOSLOT).float().mean() > 0.3
