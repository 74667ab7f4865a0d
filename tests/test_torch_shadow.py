"""PyTorch port vs the JAX package: the any-hit (shadow) query.

``any_hit_brute`` must equal JAX's exactly. The any-hit walk
(``anyhit_call`` on CPU tensors runs ``anyhit_plain``, the plain version of
the CUDA kernel) and the shadow slice (``occluded_hybrid_feats``) are held
against JAX ``occluded_hybrid_feats`` (its Pallas any-hit kernel in
interpret mode, once per case) on the same feature planes, whose phase-A
rows equal the port's, and the slice against the brute-force oracle: flags
equal, except rays at a graze or with a hit within f32 rounding of t_max
(the flip class of tests/test_shadow.py). Cases cover C = 1, group-mode
rows and C > 1 chunks; synthetic cases pin the far clip and the OR over
chunks. The CUDA kernel splits each row's walked leaves into items and ORs
the flags: a model of that split built from the plain walk must give the
whole-row flags.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tracer_torch as tt
from tests import torch_parity as tp
from tests.torch_parity import one_thread  # noqa: F401
from tracer.core.types import Ray as JRay
from tracer.intersect import brute as jbrute
from tracer.kernels import conecull as jcone
from tracer_torch.intersect.brute import any_hit_brute
from tracer_torch.kernels.leafcull import (anyhit_call, anyhit_plain,
                                           leafcull_plain, pack_ray_features)

S, SP, CELL_BITS = 8, 64, 4
RAYS = 768
# case -> (spheres, world, ray origin span, t_max, max_candidates,
#          max_chunk_bytes)
# "group_mode" runs C = 1 with leaf-mode and group-mode rows side by side.
CASES = {
    "group_mode": (2048, 120.0, 30.0, 25.0, 7, 9 << 20),
    "chunked": (4096, 150.0, 20.0, 60.0, 119, 1 << 18),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """Scene, both tables, shadow feature planes and the port's rows."""
    n, world, span, t_max, mc, chunk_bytes = CASES[request.param]
    c, r, a = tp.scene_np(n, seed=n, world=world)
    jscene, tscene = tp.scenes(c, r, a)
    jb, tb = tp.bvhs(c, r, 8)
    jt = jcone.build_cone_tables(jscene, jb, max_chunk_bytes=chunk_bytes)
    t = tt.build_cone_tables(tscene, tb, max_chunk_bytes=chunk_bytes)
    rng = np.random.default_rng(n + int(span))
    _, d = tp.origin_rays_np(RAYS, seed=n)
    o = rng.uniform(-span, span, (RAYS, 3)).astype(np.float32)
    tm = torch.full((RAYS,), t_max)
    feats, dest = tt.prep_feats_bucketed(
        torch.as_tensor(o), torch.as_tensor(d), S, SP, cell_bits=CELL_BITS,
        t_max=tm)
    rows, _, ovf = tt.cone_candidates(feats, t, 64, mc)
    assert not bool(ovf)
    rows = rows.reshape(t.cull.num_chunks, feats.shape[0], S, -1)
    jocc, jovf = jcone.occluded_hybrid_feats(tp.jfeats(feats), jt, 64, mc,
                                             interpret=True)
    return dict(name=request.param, scene=tscene, tables=t, feats=feats,
                dest=dest, rows=rows, rays=(o, d), t_max=t_max, mc=mc,
                jax=(tp.np_(jocc) > 0, bool(jovf)))


def _walk_args(case):
    cull = case["tables"].cull
    return (case["feats"], case["rows"], cull.prims, cull.leaf_size,
            cull.leaves_per_chunk, cull.leaves_per_group)


def _walk_rays(feats):
    """Per-ray (o, d) of (G, S, SP, FEAT) planes in (G, SP, S) order."""
    f = tp.np_(feats).transpose(0, 2, 1, 3).reshape(-1, feats.shape[-1])
    return -0.5 * f[:, 3:6], f[:, 0:3]


def test_any_hit_brute_matches_jax():
    rng = np.random.default_rng(4)
    o = rng.uniform(-5, 5, (300, 3)).astype(np.float32)
    d = rng.normal(size=(300, 3)).astype(np.float32)
    c = rng.uniform(-20, 20, (40, 3)).astype(np.float32)
    r = rng.uniform(0.5, 6.0, 40).astype(np.float32)
    tm = rng.uniform(1.0, 40.0, 300).astype(np.float32)
    jscene, tscene = tp.scenes(c, r, np.zeros_like(c))
    want = jbrute.any_hit_brute(
        JRay(origin=jnp.asarray(o), direction=jnp.asarray(d)), jscene,
        jnp.asarray(tm))
    for block in (64, 8192):
        got = any_hit_brute(tt.Ray(origin=torch.as_tensor(o),
                                   direction=torch.as_tensor(d)), tscene,
                            torch.as_tensor(tm), block=block)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(tp.np_(got), tp.np_(want))
    assert tp.np_(want).any() and not tp.np_(want).all()
    # A scalar t_max broadcasts over the rays.
    got = any_hit_brute(tt.Ray(origin=torch.as_tensor(o),
                               direction=torch.as_tensor(d)), tscene, 10.0)
    want = jbrute.any_hit_brute(
        JRay(origin=jnp.asarray(o), direction=jnp.asarray(d)), jscene, 10.0)
    np.testing.assert_array_equal(tp.np_(got), tp.np_(want))


def test_anyhit_call_matches_jax(case):
    occ = anyhit_call(*_walk_args(case))
    feats = case["feats"]
    G, _, _, _ = feats.shape
    assert tuple(occ.shape) == (G, SP, S) and occ.dtype == torch.int32
    o, d = _walk_rays(feats)
    tp.assert_occ_matches(occ.reshape(-1), case["jax"][0], o, d,
                          case["scene"].centers, case["scene"].radii,
                          case["t_max"])
    assert tp.np_(occ).any() and not tp.np_(occ).all()
    rows = tp.np_(case["rows"])
    if case["name"] == "group_mode":
        assert rows.shape[0] == 1
        assert (rows[..., 0] < 0).any() and (rows[..., 0] > 0).any()
    if case["name"] == "chunked":
        assert rows.shape[0] > 1


def test_anyhit_equals_closest_hit_before_t_max(case):
    """On the same rows, a ray is occluded exactly when the closest-hit
    walk finds, in some chunk, a hit with u > -a*t_max (the far clip).
    The walk returns t = -u/a, rounded once: rays whose hit sits within
    that rounding of the clip are left out."""
    occ = anyhit_plain(*_walk_args(case), pair_elems=1 << 12)
    t, slot = leafcull_plain(*_walk_args(case))
    f = tp.np_(case["feats"]).transpose(0, 2, 1, 3).astype(np.float64)
    u = -tp.np_(t).astype(np.float64) * f[..., 10]      # (C, G, SP, S)
    clip = f[..., 13]
    hit = tp.np_(slot) < 2 ** 30
    near = (hit & (u > clip)).any(axis=0)
    edge = (hit & (np.abs(u - clip) <= 1e-5 * np.abs(clip))).any(axis=0)
    assert edge.sum() <= 2
    np.testing.assert_array_equal(tp.np_(occ)[~edge] > 0, near[~edge])
    assert near.any()


def test_occluded_hybrid_matches_jax_and_brute(case):
    feats, tables, mc = case["feats"], case["tables"], case["mc"]
    occ, ovf = tt.occluded_hybrid_feats(feats, tables, 64, mc)
    jocc, jovf = case["jax"]
    assert not bool(ovf) and not jovf
    o, d = _walk_rays(feats)
    scene = case["scene"]
    tp.assert_occ_matches(occ, jocc, o, d, scene.centers, scene.radii,
                          case["t_max"])
    k = tt.kernel_order_dest(case["dest"], S, SP)
    ro, rd = (torch.as_tensor(x) for x in case["rays"])
    ref = any_hit_brute(tt.Ray(origin=ro, direction=rd), scene,
                        case["t_max"])
    tp.assert_occ_matches(occ[k], ref, ro, rd, scene.centers, scene.radii,
                          case["t_max"])
    assert tp.np_(ref).any() and not tp.np_(ref).all()


# ---------------------------------------------------------------------------
# synthetic: the far clip and the OR over chunks
# ---------------------------------------------------------------------------

LS = 4


def _feats(t_max):
    o = torch.zeros((SP, 3))
    d = torch.tensor([[1.0, 0.0, 0.0]]).repeat(SP, 1)
    return pack_ray_features(o, d, 1, SP, t_max=torch.full((SP,), t_max))[0]


def _prims(chunks):
    """chunks: per-chunk lists of (slot, center x, radius); 2 leaves each."""
    p = torch.zeros((len(chunks), 2 * LS, 4))
    p[..., 3] = -1e30
    for ci, spheres in enumerate(chunks):
        for slot, x, r in spheres:
            p[ci, slot] = torch.tensor([x, 0.0, 0.0, r * r])
    return p


def _rows(per_chunk):
    rows = torch.full((len(per_chunk), 1, 1, 8), 2, dtype=torch.int32)
    for ci, ids in enumerate(per_chunk):
        rows[ci, 0, 0, 0] = len(ids)
        rows[ci, 0, 0, 1:1 + len(ids)] = torch.tensor(ids, dtype=torch.int32)
    return rows


def test_anyhit_far_clip_is_exclusive():
    """A sphere whose near hit lies beyond t_max does not occlude; one in
    front of it does. The hit at x = 9 (center 10, radius 1)."""
    prims = _prims([[(1, 10.0, 1.0)]])
    for t_max, want in ((8.0, 0), (9.5, 1), (1e9, 1)):
        occ = anyhit_call(_feats(t_max), _rows([[0]]), prims, LS, 2, 16)
        assert (occ == want).all(), (t_max, occ.unique())
    # A sphere around the origin (its near root is behind) and one behind.
    prims = _prims([[(0, 0.0, 1.0), (2, -8.0, 1.0)]])
    assert not anyhit_call(_feats(1e9), _rows([[0]]), prims, LS, 2,
                           16).any()


def test_anyhit_ors_over_chunks_and_skips_empty_rows():
    prims = _prims([[(1, 10.0, 1.0)], [(2, 30.0, 1.0)]])
    rows = _rows([[], [0]])                 # chunk 0 empty, chunk 1 walks
    assert anyhit_call(_feats(40.0), rows, prims, LS, 2, 16).all()
    assert not anyhit_call(_feats(20.0), rows, prims, LS, 2, 16).any()
    assert anyhit_call(_feats(20.0), _rows([[0], [0]]), prims, LS, 2,
                       16).all()
    # Group mode: -1 groups of 2 leaves walks both leaves of group 0.
    grp = torch.full((2, 1, 1, 8), 2, dtype=torch.int32)
    grp[:, 0, 0, 0], grp[:, 0, 0, 1] = -1, 0
    assert anyhit_call(_feats(20.0), grp, prims, LS, 2, 2).all()


# ---------------------------------------------------------------------------
# the split walk: the OR over items
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_anyhit_or_over_items_equals_whole_rows(chunk):
    """The kernel's split walk modelled with the plain walk: each item's
    leaves walked by anyhit_plain as a row of their own (over the table as
    one chunk, so the global slots stay), the flags ORed over the items of
    every chunk; equal to the whole-row walk, in leaf and group mode."""
    feats, cand, prims, ls, lpc, lpg = tp.tie_leaves(44, t_max=25.0)
    whole = anyhit_plain(feats, cand, prims, ls, lpc, lpg)
    G, S, SP, F = feats.shape
    C = cand.shape[0]
    row, sub = tp.leaf_item_rows(cand, lpg, chunk)
    gs = row % (G * S)
    sub[:, 1:] += (row // (G * S) * lpc).to(torch.int32)[:, None]
    occ = anyhit_plain(feats.reshape(G * S, 1, SP, F)[gs], sub[None, :, None],
                       prims.reshape(1, -1, 4), ls, C * lpc, lpg)
    ors = torch.zeros((G * S, SP), dtype=torch.int32)
    ors.index_put_((gs,), occ[:, :, 0], accumulate=True)
    got = (ors > 0).reshape(G, S, SP).permute(0, 2, 1).to(torch.int32)
    assert torch.equal(got, whole)
    assert whole.any() and not whole.all()
