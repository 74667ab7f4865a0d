"""PyTorch port vs the JAX package: the TLAS-routed multi-chunk query.

Small chunk budgets split a 4096-sphere scene into several chunks (as in
tests/test_tlas.py). Routing (``route_pairs``) and routed phase A
(``tlas_candidates``) must give exactly the JAX pair tables, merge
positions, rows and overflow flags; the routed walk (``routed_call`` on CPU
tensors runs ``routed_plain``, the plain version of the CUDA kernel) exactly
JAX ``_routed_call``'s slots, t to the leaf-walk tolerance; and the whole
routed query (at small budgets, so group-mode rows are walked) exactly the
slots of JAX's (on the spread-origin rays), of the port's dense
multi-chunk query and of brute force. The JAX side runs its Pallas kernels
in interpret mode, the routed one once per module. One case pins the port's deliberate difference: group-mode
rows that need more groups than the JAX prefix keeps list every group.
The routed walk also meets skewed rows (one row per chunk walks every
group, the others 1-2 leaves), against JAX's routed kernel, and a model of
the kernel's split walk (items over the routed rows, merged by (-u, global
slot)) must equal ``routed_plain`` bit for bit, ties across leaves
included.
"""

import numpy as np
import pytest
import torch

import tracer_torch as tt
from tests import torch_parity as tp
from tests.torch_parity import one_thread  # noqa: F401
from tracer.kernels import conecull as jcone
from tracer.kernels import tlas as jtlas
from tracer_torch.kernels import tilewalk as tw
from tracer_torch.kernels import tlas as ttlas
from tracer_torch.kernels.conecull import bounds_from_feats
from tracer_torch.kernels.leafcull import (MISS_KEY, _BIG, _NOSLOT,
                                           closest_rows_u)

S, SP, CELL_BITS = 8, 64, 4
CHUNK_BYTES = 1 << 18


@pytest.fixture(scope="module")
def world():
    """Scene, JAX and port tables, and feature planes of origin rays and of
    spread-origin rays (made by the port's prep, handed to both)."""
    c, r, a = tp.scene_np(4096, seed=1, world=150.0)
    jscene, tscene = tp.scenes(c, r, a)
    jb, tb = tp.bvhs(c, r, 8)
    jt = jcone.build_cone_tables(jscene, jb, max_chunk_bytes=CHUNK_BYTES)
    t = tt.build_cone_tables(tscene, tb, max_chunk_bytes=CHUNK_BYTES)
    assert t.cull.num_chunks > 1
    feats = {}
    for span in (0.0, 30.0):
        rng = np.random.default_rng(int(span) + 5)
        _, d = tp.origin_rays_np(1024, seed=int(span))
        o = rng.uniform(-span, span, (1024, 3)).astype(np.float32)
        f, dest = tt.prep_feats_bucketed(torch.as_tensor(o),
                                         torch.as_tensor(d), S, SP,
                                         cell_bits=CELL_BITS)
        feats[span] = (f, dest, o, d)
    return dict(scene=tscene, tables=t, jtables=jt, feats=feats)


# The routed query's budgets in the walk and query tests: small group and
# leaf budgets, so that group-mode rows run through the routed walk.
MG, MC, NPAIRS, KC = 8, 7, 4096, 32


@pytest.fixture(scope="module")
def jax_routed(world):
    """JAX's routed query on the spread-origin rays, stage by stage as
    ``nearest_hit_tlas_split`` runs it (interpret mode, compiled once):
    (pair_c, pair_gb, per-pair t, per-pair slot, t, slot, overflow)."""
    jt = world["jtables"]
    rows, pc, pg, mp, ovf = jtlas.tlas_candidates(
        tp.jfeats(world["feats"][30.0][0]), jt, MG, MC, NPAIRS, KC,
        interpret=True)
    cull = jt.cull
    t_p, s_p = jtlas._routed_call(pc, pg, rows, tp.jfeats(
        world["feats"][30.0][0]), cull.entries, S, SP, cull.leaf_size,
        cull.leaves_per_chunk, cull.leaves_per_group, interpret=True)
    t, slot = jtlas._tlas_merge(t_p, s_p, mp)
    return tuple(tp.np_(x) for x in (pc, pg, t_p, s_p, t, slot, ovf))


@pytest.mark.parametrize("npairs,kc", [(4096, 32), (64, 4), (2, 1)])
def test_route_pairs_match_jax(world, npairs, kc):
    feats = world["feats"][30.0][0]
    got = ttlas.route_pairs(*bounds_from_feats(feats), world["tables"], S,
                            npairs, kc)
    jb = jcone.bounds_from_feats(tp.jfeats(feats))
    want = jtlas.route_pairs(*jb, world["jtables"], S, npairs, kc,
                             interpret=True)
    for name, g, w in zip(("pair_c", "pair_gb", "active", "merge_pos",
                           "overflow"), got, want):
        np.testing.assert_array_equal(tp.np_(g), tp.np_(w), err_msg=name)
    assert got[0].dtype == got[1].dtype == got[3].dtype == torch.int32
    assert bool(got[4]) == (npairs < 4096)


@pytest.mark.parametrize("mg,mc,pair_block", [(64, 119, 8192), (8, 7, 64)])
def test_tlas_candidates_match_jax(world, mg, mc, pair_block):
    feats = world["feats"][30.0][0]
    rows, pc, pg, mp, ovf = ttlas.tlas_candidates(
        feats, world["tables"], mg, mc, 4096, 32, pair_block)
    want = jtlas.tlas_candidates(tp.jfeats(feats), world["jtables"], mg, mc,
                                 4096, 32, pair_block=pair_block,
                                 interpret=True)
    np.testing.assert_array_equal(tp.np_(rows),
                                  tp.np_(want[0]).reshape(rows.shape))
    for g, w in zip((pc, pg, mp), want[1:4]):
        np.testing.assert_array_equal(tp.np_(g), tp.np_(w))
    assert not bool(ovf) and not bool(want[4])
    counts = tp.np_(rows)[..., 0]
    assert (counts > 0).any()
    if mc == 7:
        assert (counts < 0).any()       # group-mode rows, several blocks


def test_routed_call_matches_jax(world, jax_routed):
    feats = world["feats"][30.0][0]
    cull = world["tables"].cull
    rows, pc, pg, _, _ = ttlas.tlas_candidates(feats, world["tables"], MG,
                                               MC, NPAIRS, KC)
    jpc, jpg, jt, js = jax_routed[:4]
    np.testing.assert_array_equal(tp.np_(pc), jpc)
    np.testing.assert_array_equal(tp.np_(pg), jpg)
    assert (rows[:, :, 0] < 0).any() and len(set(pc.tolist())) > 1
    t, slot = ttlas.routed_call(pc, pg, rows, feats, cull.prims,
                                cull.leaf_size, cull.leaves_per_chunk,
                                cull.leaves_per_group)
    assert tuple(t.shape) == (pc.shape[0], SP, S) and slot.dtype == torch.int32
    np.testing.assert_array_equal(tp.np_(slot), js)
    hit = tp.np_(slot) < 2 ** 30
    assert hit.any() and not hit.all()
    # Each pair's rays are packet pair_gb[p]'s: t checked per pair.
    for p in np.nonzero(hit.any(axis=(1, 2)))[0]:
        tp.assert_walk_t_close(t[p][None], jt[p][None],
                               feats[int(pg[p])][None], slot[p][None],
                               cull.prims)


@pytest.mark.parametrize("span", [0.0, 30.0])
def test_tlas_query_matches_jax_dense_and_brute(world, jax_routed, span):
    feats, dest, o, d = world["feats"][span]
    tables = world["tables"]
    t, slot, ovf = tt.nearest_hit_tlas_feats(feats, tables, MG, MC, NPAIRS,
                                             KC)
    assert not bool(ovf)
    if span:
        jt, js, jovf = jax_routed[4:]
        assert not bool(jovf)
        np.testing.assert_array_equal(tp.np_(slot), js)
        G = feats.shape[0]
        raw = torch.where(slot >= 0, slot, 2 ** 30).reshape(G, SP, S)
        tp.assert_walk_t_close(t.reshape(G, SP, S), jt.reshape(G, SP, S),
                               feats, raw, tables.cull.prims)
    td, sd, dovf = tt.nearest_hit_hybrid_feats(feats, tables, MG, MC)
    assert not bool(dovf)
    np.testing.assert_array_equal(tp.np_(slot), tp.np_(sd))
    assert torch.equal(t, td)
    k = tt.kernel_order_dest(dest, S, SP)
    s = slot[k]
    sid = torch.where(s >= 0, tables.cull.slot_to_sphere[s.clamp(min=0)], -1)
    ref = tt.nearest_hit_brute(tt.Ray(origin=torch.as_tensor(o),
                                      direction=torch.as_tensor(d)),
                               world["scene"])
    np.testing.assert_array_equal(tp.np_(sid), tp.np_(ref.index))
    assert (tp.np_(sid) >= 0).any()


def test_tlas_overflow_flag_on_tiny_budgets(world):
    feats = world["feats"][0.0][0]
    _, _, ovf = tt.nearest_hit_tlas_feats(feats, world["tables"], npairs=2,
                                          kc=1)
    assert bool(ovf)


def test_tlas_merge_takes_the_first_chunk_on_ties():
    """Two routed pairs of g-block 0 with equal t: the earlier position
    (the lower chunk) wins; an unused position reads as a miss."""
    t_p = torch.full((3, 2, 1), 5.0)
    slot_p = torch.tensor([7, 9, 11], dtype=torch.int32)[:, None, None] \
        .expand(3, 2, 1).contiguous()
    t_p[2] = 1.0                              # a nearer hit in g-block 1
    merge_pos = torch.tensor([[1, 0, 3], [2, 3, 3]], dtype=torch.int32)
    t, slot = ttlas.tlas_merge(t_p, slot_p, merge_pos)
    assert slot.tolist() == [9, 9, 11, 11] and t.tolist() == [5, 5, 1, 1]
    t, slot = ttlas.tlas_merge(t_p, slot_p,
                               torch.full((1, 2), 3, dtype=torch.int32))
    assert slot.tolist() == [-1, -1] and torch.isinf(t).all()


def test_group_rows_list_every_group_where_jax_pads_them():
    """With 152 groups in a chunk, group-mode rows may list up to kg = 152
    groups while the JAX group prefix keeps 128: JAX pads the rows that
    need more with the sentinel group id (and raises no flag); the port
    lists every group, its other rows equal JAX's, and the routed query
    equals brute force."""
    c, r, a = tp.scene_np(8192, seed=2, world=100.0)
    jscene, tscene = tp.scenes(c, r, a)
    jb, tb = tp.bvhs(c, r, 2)
    jt = jcone.build_cone_tables(jscene, jb)
    t = tt.build_cone_tables(tscene, tb)
    gpc = t.cull.leaves_per_chunk // t.cull.leaves_per_group
    rng = np.random.default_rng(0)
    d = rng.uniform(0, 1, (1024, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = rng.uniform(-30, 30, (1024, 3)).astype(np.float32)
    feats, _, _ = tt.pack_ray_features(torch.as_tensor(o),
                                       torch.as_tensor(d), S, SP)
    rows, _, _, _, ovf = ttlas.tlas_candidates(feats, t, 8, 119, 4096, 32)
    jrows = tp.np_(jtlas.tlas_candidates(tp.jfeats(feats), jt, 8, 119, 4096,
                                         32, interpret=True)[0])
    rows = tp.np_(rows)
    jrows = jrows.reshape(rows.shape)
    n = -rows[..., 0]
    wide = n > 128
    assert gpc == 152 and wide.any() and not bool(ovf)
    listed = wide[..., None] & (np.arange(rows.shape[-1] - 1) < n[..., None])
    assert (rows[..., 1:][listed] < gpc).all()
    assert (jrows[..., 1:][listed] == gpc).any()
    np.testing.assert_array_equal(rows[~wide], jrows[~wide])

    t_r, s_r, ovf = tt.nearest_hit_tlas_feats(feats, t, 8, 119)
    assert not bool(ovf)
    ids = torch.where(s_r >= 0, t.cull.slot_to_sphere[s_r.clamp(min=0)], -1)
    kod = tt.kernel_order_dest(torch.arange(1024), S, SP)
    ref = tt.nearest_hit_brute(tt.Ray(origin=torch.as_tensor(o),
                                      direction=torch.as_tensor(d)), tscene)
    np.testing.assert_array_equal(tp.np_(ids[kod]), tp.np_(ref.index))


def _skewed_pairs(C, G, lpc, lpg, rowlen, seed):
    """Routed pairs over C chunks, chunk-major, two g-blocks each (the last
    chunk's second pair all empty rows), and their (Np, S, rowlen) rows:
    the first row of each chunk's first pair walks every group of the
    chunk, the others list 1-2 random leaves."""
    rng = np.random.default_rng(seed)
    gpc = lpc // lpg
    pc = np.repeat(np.arange(C), 2).astype(np.int32)
    pg = np.tile([0, G - 1], C).astype(np.int32)
    rows = np.full((2 * C, S, rowlen), lpc, np.int32)
    rows[..., 0] = rng.integers(1, 3, (2 * C, S))
    rows[..., 1:3] = rng.integers(0, lpc, (2 * C, S, 2))
    rows[0::2, 0, 0] = -gpc
    rows[0::2, 0, 1:1 + gpc] = np.arange(gpc)
    rows[0::2, 0, 1 + gpc:] = gpc
    rows[-1, :, 0] = 0
    return (torch.as_tensor(pc), torch.as_tensor(pg), torch.as_tensor(rows))


def test_routed_skewed_rows_match_jax(world):
    """routed_plain against JAX's routed kernel on skewed rows: slots
    exactly, t to the leaf walks' tolerance."""
    feats = world["feats"][30.0][0]
    cull, jcull = world["tables"].cull, world["jtables"].cull
    lpc, lpg = cull.leaves_per_chunk, cull.leaves_per_group
    rowlen = ttlas.tlas_candidates(feats, world["tables"], MG, MC, NPAIRS,
                                   KC)[0].shape[-1]
    assert rowlen > lpc // lpg
    pc, pg, rows = _skewed_pairs(cull.num_chunks, feats.shape[0], lpc, lpg,
                                 rowlen, seed=3)
    t, slot = ttlas.routed_call(pc, pg, rows, feats, cull.prims,
                                cull.leaf_size, lpc, lpg)
    jt, js = jtlas._routed_call(tp.to_jax(pc), tp.to_jax(pg),
                                tp.to_jax(rows[:, None]), tp.jfeats(feats),
                                jcull.entries, S, SP, cull.leaf_size, lpc,
                                lpg, interpret=True)
    np.testing.assert_array_equal(tp.np_(slot), tp.np_(js))
    hit = tp.np_(slot) < 2 ** 30
    assert hit[0::2, :, 0].any() and not hit[-1].any()
    for p in np.nonzero(hit.any(axis=(1, 2)))[0]:
        tp.assert_walk_t_close(t[p][None], tp.np_(jt)[p][None],
                               feats[int(pg[p])][None], slot[p][None],
                               cull.prims)


def routed_split_merge(pc, pg, rows, feats, prims, ls, lpg, chunk):
    """The routed kernel's split walk modelled with the plain walk: rows
    r = p * S + s cut into items of ``chunk`` walked leaves, each item
    walked by closest_rows_u as a row of its own on chunk pc[p] and
    feature row pg[p] * S + s, each ray's (-u, global slot) key
    min-merged over the items, then unpacked as the epilogue does:
    t = (-u) * (1/a), (3e38, 2^30) for a miss; (Np, SP, S)."""
    G, S_, SP_, F = feats.shape
    Np = rows.shape[0]
    item_row, sub = tp.leaf_item_rows(rows, lpg, chunk)
    p = item_row // S_
    fidx = pg.long()[p] * S_ + item_row % S_
    u, slot = closest_rows_u(feats.reshape(G * S_, SP_, F), fidx,
                             pc.long()[p], sub, prims, ls, lpg)
    key = torch.where(slot < _NOSLOT, tw.pack_keys(-u, slot), MISS_KEY)
    keys = torch.full((Np * S_ * SP_,), MISS_KEY, dtype=torch.int64)
    keys.scatter_reduce_(0, (item_row[:, None] * SP_
                             + torch.arange(SP_)).reshape(-1),
                         key.reshape(-1), "amin")
    keys = keys.reshape(Np, S_, SP_)
    nu, s = tw.unpack_keys(keys)
    r = torch.arange(Np * S_)
    inva = feats.reshape(G * S_, SP_, F)[pg.long()[r // S_] * S_ + r % S_,
                                         :, 11].reshape(Np, S_, SP_)
    miss = keys == MISS_KEY
    t = torch.where(miss, _BIG, nu * inva)
    s = torch.where(miss, _NOSLOT, s).to(torch.int32)
    return t.permute(0, 2, 1).contiguous(), s.permute(0, 2, 1).contiguous()


@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_routed_split_and_merge_equals_whole_rows(chunk):
    """Routed rows over the two-chunk tie table (one sphere stored twice in
    chunk 0, in leaves 1 and 5): pairs (chunk, g-block) in chunk-major
    order; items that split the two copies apart (1 leaf) or keep them
    together (8), in leaf and group mode, bit for bit."""
    feats, cand, prims, ls, lpc, lpg = tp.tie_leaves(44)
    C, G = cand.shape[:2]
    pc = torch.arange(C, dtype=torch.int32).repeat_interleave(G)
    pg = torch.arange(G, dtype=torch.int32).repeat(C)
    rows = cand.reshape(C * G, *cand.shape[2:])
    t, slot = ttlas.routed_plain(pc, pg, rows, feats, prims, ls, lpc, lpg)
    got = routed_split_merge(pc, pg, rows, feats, prims, ls, lpg, chunk)
    assert torch.equal(got[0], t) and torch.equal(got[1], slot)
    assert (slot == tp.LEAF_DUP[0]).sum() > 5
    assert not (slot == tp.LEAF_DUP[1]).any()
    assert (slot[0, :, 0] == _NOSLOT).all()               # the empty row
    assert (slot < _NOSLOT).float().mean() > 0.2
