"""PyTorch port vs the JAX package: phase A (bounds, slab tests, the row
compactor, cone_candidates) and the whole closest-hit slice.

Both sides take the same feature planes, so rows and overflow flags must be
identical, including group-mode rows (leaf budget 7), C > 1 chunks (small
max_chunk_bytes) and overflow (unsorted rays over a 16k-sphere scene with
more groups than a group-mode row holds). The JAX side
runs its Pallas kernels in interpret mode, each case once per module.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tracer_torch as tt
from tests import torch_parity as tp
from tracer.core.sort import prep_rays_bucketed as j_prep_rays
from tracer.core.types import Ray as JRay
from tracer.intersect.brute import nearest_hit_brute as j_brute
from tracer.kernels import conecull as jcone
from tracer.kernels import leafcull as jleaf
from tracer_torch.kernels import conecull as tcone

N, LEAF = 700, 8
CHUNK_BYTES = 80 * 1024
# A scene with more groups per chunk than a group-mode row can list, so
# that unsorted rays (whose subpacket bounds span every direction)
# overflow.
N_LARGE = 16000
# case -> (tables, unsorted rays?, max_groups, max_candidates)
ROW_CASES = {
    "default": ("small", False, 64, 119),
    "group_mode": ("small", False, 64, 7),
    "chunked": ("chunked", False, 64, 119),
    "overflow": ("large", True, 64, 7),
}


@pytest.fixture(scope="module")
def world():
    c, r, a = tp.scene_np(N, seed=3)
    jscene, tscene = tp.scenes(c, r, a)
    jb, tb = tp.bvhs(c, r, LEAF)
    cl, rl, al = tp.scene_np(N_LARGE, seed=4, world=200.0)
    jlarge, tlarge = tp.scenes(cl, rl, al)
    jbl, tbl = tp.bvhs(cl, rl, LEAF)
    tables = {"small": (jcone.build_cone_tables(jscene, jb),
                        tt.build_cone_tables(tscene, tb)),
              "chunked": (jcone.build_cone_tables(jscene, jb,
                                                  max_chunk_bytes=CHUNK_BYTES),
                          tt.build_cone_tables(tscene, tb,
                                               max_chunk_bytes=CHUNK_BYTES)),
              "large": (jcone.build_cone_tables(jlarge, jbl),
                        tt.build_cone_tables(tlarge, tbl))}
    o, d = tp.origin_rays_np(1024)
    sorted_feats, _ = jleaf.prep_feats_bucketed(
        jnp.asarray(o), jnp.asarray(d), tp.S, tp.SP, cell_bits=tp.CELL_BITS)
    unsorted_feats, _, _ = jleaf.pack_ray_features(
        jnp.asarray(o), jnp.asarray(d), tp.S, tp.SP)
    return dict(scene=(jscene, tscene), tables=tables, rays=(o, d),
                feats={False: sorted_feats, True: unsorted_feats})


@pytest.fixture(scope="module")
def jax_rows(world):
    """JAX cone_candidates (interpret mode) for every row case, once."""
    out = {}
    for name, (key, unsorted, mg, mc) in ROW_CASES.items():
        rows, _, ovf = jcone.cone_candidates(
            world["feats"][unsorted], world["tables"][key][0], mg, mc,
            interpret=True)
        out[name] = (tp.np_(rows), bool(ovf))
    return out


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P,M,keep", [(16, 128, 128), (24, 384, 200),
                                      (8, 1024, 512)])
def test_compact_ascending_rows_matches_jax(P, M, keep):
    rng = np.random.default_rng(P + M)
    ids = np.cumsum(rng.integers(1, 4, (P, M)), axis=1).astype(np.int32)
    sentinel = 4 * M + 1
    mask = rng.random((P, M)) < rng.random((P, 1))
    mask[0], mask[1] = False, True                # all masked / none masked
    ids = np.where(mask, ids, sentinel).astype(np.int32)
    jout, jcnt = jcone.compact_ascending_rows(jnp.asarray(ids), sentinel,
                                              keep, interpret=True)
    out, cnt = tt.compact_ascending_rows(torch.as_tensor(ids), sentinel, keep)
    assert out.dtype == cnt.dtype == torch.int32
    np.testing.assert_array_equal(tp.np_(out), tp.np_(jout))
    np.testing.assert_array_equal(tp.np_(cnt), tp.np_(jcnt))


@pytest.mark.parametrize("unsorted", [False, True])
def test_bounds_and_slab_tests_match_jax(world, unsorted):
    jfeats = world["feats"][unsorted]
    jb = jcone.bounds_from_feats(jfeats)
    tb = tcone.bounds_from_feats(tp.to_torch(jfeats))
    for got, want in zip(tb, jb):
        np.testing.assert_array_equal(tp.np_(got), tp.np_(want))
    cull_j, cull_t = (x.cull for x in world["tables"]["small"])
    want = jcone._slab_hit_cols(
        *jb, tuple(cull_j.leaf_min[None, :, a] for a in range(3)),
        tuple(cull_j.leaf_max[None, :, a] for a in range(3)))
    got = tcone._slab_hit_cols(
        *tb, tuple(cull_t.leaf_min[None, :, a] for a in range(3)),
        tuple(cull_t.leaf_max[None, :, a] for a in range(3)))
    np.testing.assert_array_equal(tp.np_(got), tp.np_(want))
    assert tp.np_(want).any()
    if not unsorted:
        assert not tp.np_(want).all()


@pytest.mark.parametrize("case", sorted(ROW_CASES))
def test_cone_candidates_rows_match_jax(world, jax_rows, case):
    key, unsorted, mg, mc = ROW_CASES[case]
    feats = tp.to_torch(world["feats"][unsorted])
    rows, cones, ovf = tt.cone_candidates(feats, world["tables"][key][1],
                                          mg, mc)
    want_rows, want_ovf = jax_rows[case]
    assert cones is None and rows.dtype == torch.int32
    np.testing.assert_array_equal(tp.np_(rows), want_rows)
    assert bool(ovf) == want_ovf
    if case == "group_mode":
        assert (want_rows[:, :, 0] < 0).any()
    if case == "chunked":
        assert want_rows.shape[0] > 1
    assert want_ovf == (case == "overflow")


# ---------------------------------------------------------------------------
# the slice
# ---------------------------------------------------------------------------

def _slot_sphere_ids(t_raw, slot_raw, s2s, n):
    """Raw-order (t, slot) -> ray-order (t, sphere id) for n packet-order
    rays (padded ray i sits at kernel_order_dest(i))."""
    kod = tp.np_(tcone.kernel_order_dest(torch.arange(n), tp.S, tp.SP))
    t, s = tp.np_(t_raw)[kod], tp.np_(slot_raw)[kod]
    return t, np.where(s >= 0, tp.np_(s2s)[np.maximum(s, 0)], -1)


def test_hybrid_raw_matches_jax_and_brute(world):
    o, d = world["rays"]
    jt, tt_ = world["tables"]["small"]
    padded, _ = j_prep_rays(JRay(origin=jnp.asarray(o),
                                 direction=jnp.asarray(d)), tp.SP,
                            cell_bits=tp.CELL_BITS)
    jt_raw, js_raw, jovf = jcone.nearest_hit_hybrid_raw(
        padded, jt, subpackets=tp.S, subpacket=tp.SP, interpret=True)
    rays = tt.Ray(origin=tp.to_torch(padded.origin),
                  direction=tp.to_torch(padded.direction))
    t_raw, s_raw, ovf = tt.nearest_hit_hybrid_raw(rays, tt_, subpackets=tp.S,
                                                  subpacket=tp.SP)
    assert not bool(ovf) and not bool(jovf)
    np.testing.assert_array_equal(tp.np_(s_raw), tp.np_(js_raw))
    hit = tp.np_(js_raw) >= 0
    assert hit.any() and not hit.all()
    # Same kernel arithmetic, but XLA contracts mul+add where torch rounds
    # each op: 2e-4 is the repo's kernel-vs-brute tolerance.
    np.testing.assert_allclose(tp.np_(t_raw)[hit], tp.np_(jt_raw)[hit],
                               rtol=2e-4)
    assert np.isinf(tp.np_(t_raw)[~hit]).all()

    n = padded.origin.shape[0]
    t, sid = _slot_sphere_ids(t_raw, s_raw, tt_.cull.slot_to_sphere, n)
    ref = tt.nearest_hit_brute(rays, world["scene"][1])
    jref = j_brute(padded, world["scene"][0])
    np.testing.assert_array_equal(sid, tp.np_(ref.index))
    np.testing.assert_array_equal(sid, tp.np_(jref.index))
    ok = sid >= 0
    np.testing.assert_allclose(t[ok], tp.np_(ref.t)[ok], rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("key,mc", [("chunked", 119), ("small", 7),
                                    ("chunked", 7)])
def test_hybrid_feats_matches_brute(world, key, mc):
    """Prep + phase A + leaf walk through the public entry points, for
    chunked tables and group-mode rows, against the brute-force oracle."""
    o, d = (torch.as_tensor(x) for x in world["rays"])
    tables = world["tables"][key][1]
    feats, dest = tt.prep_feats_bucketed(o, d, tp.S, tp.SP,
                                         cell_bits=tp.CELL_BITS)
    t, slot, ovf = tt.nearest_hit_hybrid_feats(feats, tables, 64, mc)
    assert not bool(ovf)
    k = tt.kernel_order_dest(dest, tp.S, tp.SP)
    s = slot[k]
    sid = torch.where(s >= 0, tables.cull.slot_to_sphere[s.clamp(min=0)], -1)
    ref = tt.nearest_hit_brute(tt.Ray(origin=o, direction=d),
                               world["scene"][1])
    np.testing.assert_array_equal(tp.np_(sid), tp.np_(ref.index))
    ok = tp.np_(sid) >= 0
    assert ok.any()
    np.testing.assert_allclose(tp.np_(t[k])[ok], tp.np_(ref.t)[ok],
                               rtol=2e-4, atol=1e-4)
