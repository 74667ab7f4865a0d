"""PyTorch port vs the JAX package: the closest-hit leaf walk.

``leafcull_call`` on CPU tensors runs ``leafcull_plain``, the plain version
of the CUDA kernel. It is held against JAX ``_leafcull_call`` (Pallas, in
interpret mode) on the SAME feature planes and candidate rows: slots
exactly, t to 1e-5 relative. Cases cover leaf sizes 8 and 32, group-mode
rows and C > 1 chunks (the min-merge). Synthetic cases pin the tie-break
rules, and a walk over every group is held against brute force.
"""

import numpy as np
import pytest
import torch

import tracer_torch as tt
from tests import torch_parity as tp
from tests.torch_parity import one_thread  # noqa: F401
from tracer.kernels import conecull as jcone
from tracer.kernels.leafcull import _leafcull_call as j_leafcull_call
from tracer_torch.kernels.leafcull import (leafcull_plain, pack_ray_features,
                                           _walk_pairs, _BIG, _NOSLOT)

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
        tp.to_jax(feats), tp.to_jax(rows), jt.cull.entries, tp.S, tp.SP,
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
    p[..., 3] = 1e30                                 # sentinel slots
    for ci, spheres in enumerate(chunks):
        for slot, x, r in spheres:
            p[ci, slot] = torch.tensor([x, 0.0, 0.0, x * x - r * r])
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
