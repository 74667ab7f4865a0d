"""PyTorch port vs the JAX package: the LBVH built on the scene's device.

``morton_codes_3d`` and ``build_bvh_device`` must give exactly the JAX
arrays (NaN boxes of padding-only nodes at the same places), the tree must
pass the FlatBVH invariants, and the closest-hit query over cone tables
built from it must equal brute force, with tables equal to the JAX tables
built from the JAX LBVH.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tracer_torch as tt
from tests import torch_parity as tp
from tracer.bvh.device import (build_bvh_device as j_build,
                               morton_codes_3d as j_morton)
from tracer.kernels.conecull import build_cone_tables as j_cone_tables

FIELDS = ("node_min", "node_max", "escape", "leaf_start", "prim_idx")
S, SP, CELL_BITS = 8, 64, 4


def test_morton_codes_match_jax():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-7, 9, (4000, 3)).astype(np.float32)
    pts[:3] = [[-7, -7, -7], [9, 9, 9], [9, -7, 1]]     # clipped corners
    lo, hi = np.float32([-7, -7, -7]), np.float32([9, 9, 9])
    want = tp.np_(j_morton(jnp.asarray(pts), jnp.asarray(lo),
                           jnp.asarray(hi))).astype(np.int64)
    got = tt.morton_codes_3d(torch.as_tensor(pts), torch.as_tensor(lo),
                             torch.as_tensor(hi))
    assert got.dtype == torch.int64 and int(got.max()) < 2 ** 30
    np.testing.assert_array_equal(tp.np_(got), want)
    assert len(np.unique(want)) > 3000


@pytest.mark.parametrize("n,leaf", [(1000, 8), (1000, 32), (37, 4), (3, 8),
                                    (5000, 32)])
def test_build_bvh_device_matches_jax(n, leaf):
    c, r, _ = tp.scene_np(n, seed=n, world=100.0)
    want = j_build(jnp.asarray(c), jnp.asarray(r), leaf_size=leaf)
    got = tt.build_bvh_device(torch.as_tensor(c), torch.as_tensor(r),
                              leaf_size=leaf)
    assert got.leaf_size == leaf
    for f in FIELDS:
        assert getattr(got, f).dtype == (torch.float32 if "node" in f
                                         else torch.int32), f
        # NaN boxes (nodes over padding slots only) sit at the same places.
        np.testing.assert_array_equal(tp.np_(getattr(got, f)),
                                      tp.np_(getattr(want, f)), err_msg=f)
    # Some leaf holds padding slots only exactly when a leaf's worth of
    # slots is padding.
    assert bool(torch.isnan(got.node_min).any()) == (
        got.prim_idx.shape[0] - n >= leaf)
    tt.validate_bvh(got, c, r)


def test_build_bvh_device_stays_on_the_scene_device():
    c, r, _ = tp.scene_np(50)
    bvh = tt.build_bvh_device(torch.as_tensor(c), torch.as_tensor(r), 4)
    assert all(getattr(bvh, f).device.type == "cpu" for f in FIELDS)
    with pytest.raises(ValueError):
        tt.build_bvh_device(torch.zeros((0, 3)), torch.zeros(0))


def test_lbvh_tables_and_query_equal_jax_and_brute():
    c, r, a = tp.scene_np(3000, seed=8, world=80.0)
    jscene, tscene = tp.scenes(c, r, a)
    jt = j_cone_tables(jscene, j_build(jnp.asarray(c), jnp.asarray(r),
                                       leaf_size=32))
    t = tt.build_cone_tables(tscene, tt.build_bvh_device(
        tscene.centers, tscene.radii, leaf_size=32))
    for f in ("leaf_min", "leaf_max", "group_min", "group_max",
              "slot_to_sphere"):
        np.testing.assert_array_equal(tp.np_(getattr(t.cull, f)),
                                      tp.np_(getattr(jt.cull, f)), err_msg=f)
    np.testing.assert_array_equal(tp.np_(t.leaf_boxes), tp.np_(jt.leaf_boxes))

    o, d = tp.origin_rays_np(1024, seed=4)
    o = o + np.float32(3.0)
    feats, dest = tt.prep_feats_bucketed(torch.as_tensor(o),
                                         torch.as_tensor(d), S, SP,
                                         cell_bits=CELL_BITS)
    tq, slot, ovf = tt.nearest_hit_hybrid_feats(feats, t)
    assert not bool(ovf)
    s = slot[tt.kernel_order_dest(dest, S, SP)]
    sid = torch.where(s >= 0, t.cull.slot_to_sphere[s.clamp(min=0)], -1)
    ref = tt.nearest_hit_brute(tt.Ray(origin=torch.as_tensor(o),
                                      direction=torch.as_tensor(d)), tscene)
    np.testing.assert_array_equal(tp.np_(sid), tp.np_(ref.index))
    assert (tp.np_(sid) >= 0).any()
