"""PyTorch port vs the JAX package: the TLAS-routed query past 256 chunks.

The regime of the 100M sweep row (more than 256 table chunks, the budgets
``bench.large.budgets`` gives there, kc below the chunk count) at a small
size: 34,000 spheres at leaf 4 (the device LBVH of each package) in chunks
of one 16-leaf group, 532 chunks, and 1,024 origin rays. Routing must give
exactly JAX's pair tables, merge positions and overflow flag (clear at the
tier's kc = 512, raised at kc = 256); the whole query must equal JAX
``nearest_hit_tlas_split`` (interpret mode): overflow flags equal, slots
equal but for verified grazes (XLA contracts mul+add on the CPU), t to the
leaf walks' tolerance where the slots agree, and its ids must equal the
dense multi-chunk query's and brute force's. Kept apart from
``tests/test_torch_tlas.py``, whose shapes it shares no compilation with,
so that each file stays near a minute on one thread.
"""

import types

import numpy as np
import pytest
import torch

import tracer_torch as tt
from tests import torch_parity as tp
from tests.reference_oracle import assert_matches_brute_modulo_grazes
from tests.torch_parity import one_thread  # noqa: F401
from tracer.bvh.device import build_bvh_device as j_build_bvh_device
from tracer.kernels import conecull as jcone
from tracer.kernels import tlas as jtlas
from tracer_torch.bench.large import budgets as routed_budgets
from tracer_torch.kernels import tlas as ttlas
from tracer_torch.kernels.conecull import bounds_from_feats

S, SP, CELL_BITS = 8, 64, 4
SPHERES, LEAF, CHUNK_BYTES, RAYS = 34_000, 4, 1 << 12, 1024


@pytest.fixture(scope="module")
def wide():
    """34,000 spheres at leaf 4 (JAX's device LBVH and the port's own), cut
    into more than 512 chunks of one group; 1,024 origin rays prepped by the
    port; the budgets of the C > 256 tier."""
    c, r, a = tp.scene_np(SPHERES, seed=4, world=150.0)
    jscene, tscene = tp.scenes(c, r, a)
    jb = j_build_bvh_device(jscene.centers, jscene.radii, LEAF)
    tb = tt.build_bvh_device(tscene.centers, tscene.radii, LEAF)
    jt = jcone.build_cone_tables(jscene, jb, max_chunk_bytes=CHUNK_BYTES)
    t = tt.build_cone_tables(tscene, tb, max_chunk_bytes=CHUNK_BYTES)
    o, d = tp.origin_rays_np(RAYS, seed=0)
    feats, dest = tt.prep_feats_bucketed(torch.as_tensor(o),
                                         torch.as_tensor(d), S, SP,
                                         cell_bits=CELL_BITS)
    budget = routed_budgets(SPHERES, t.cull.num_chunks, RAYS)
    return dict(scene=tscene, tables=t, jtables=jt, feats=feats, dest=dest,
                o=o, d=d, budget=budget)


@pytest.mark.parametrize("kc", [512, 256])
def test_route_pairs_past_256_chunks_match_jax(wide, kc):
    """Routing over 532 chunks: pair tables, merge positions and the
    overflow flag equal JAX's, at the tier's kc = 512 (no g-block routes
    more chunks) and at kc = 256 (some do: both raise the flag)."""
    feats, C = wide["feats"], wide["tables"].cull.num_chunks
    npairs = min(wide["budget"][1], C * feats.shape[0])
    got = ttlas.route_pairs(*bounds_from_feats(feats), wide["tables"], S,
                            npairs, kc)
    want = jtlas.route_pairs(*jcone.bounds_from_feats(tp.to_jax(feats)),
                             wide["jtables"], S, npairs, kc, interpret=True)
    for name, g, w in zip(("pair_c", "pair_gb", "active", "merge_pos",
                           "overflow"), got, want):
        np.testing.assert_array_equal(tp.np_(g), tp.np_(w), err_msg=name)
    assert bool(got[4]) == (kc == 256)


def test_tlas_query_past_256_chunks_matches_jax_split_and_brute(wide):
    """The whole routed query at the C > 256 budgets (kc = 512 < C = 532)
    against JAX ``nearest_hit_tlas_split`` in interpret mode: overflow
    flags equal (clear), slots equal but for verified grazes, t to the
    leaf walks' tolerance where the slots agree; its ids equal the dense
    query's and brute force's."""
    feats, tables = wide["feats"], wide["tables"]
    cull = tables.cull
    budget = wide["budget"]
    assert cull.num_chunks > 512 and cull.leaves_per_chunk == 16
    assert budget == (32, 4896, 512, 4096) and budget[2] < cull.num_chunks
    mg, npairs, kc, pair_block = budget
    t, slot, ovf = tt.nearest_hit_tlas_feats(feats, tables, mg, 119, npairs,
                                             kc, pair_block)
    jt, js, jovf = jtlas.nearest_hit_tlas_split(
        tp.to_jax(feats), wide["jtables"], mg, 119, npairs, kc, pair_block,
        interpret=True)
    assert not bool(ovf) and not bool(jovf)
    js = tp.np_(js)
    k = tp.np_(tt.kernel_order_dest(wide["dest"], S, SP))
    s2s = tp.np_(cull.slot_to_sphere)

    def hits(t_raw, s_raw):
        s_ray = tp.np_(s_raw)[k]
        return types.SimpleNamespace(
            t=tp.np_(t_raw)[k],
            index=np.where(s_ray >= 0, s2s[np.maximum(s_ray, 0)], -1))
    scene = types.SimpleNamespace(centers=tp.np_(wide["scene"].centers),
                                  radii=tp.np_(wide["scene"].radii))
    rays = types.SimpleNamespace(origin=wide["o"], direction=wide["d"])
    assert_matches_brute_modulo_grazes(hits(t, slot), hits(jt, js), rays,
                                       scene)
    same = tp.np_(slot) == js
    assert same.mean() > 0.99
    G = feats.shape[0]
    raw = torch.as_tensor(np.where(same & (js >= 0), js, 2 ** 30))
    tp.assert_walk_t_close(t.reshape(G, SP, S), tp.np_(jt).reshape(G, SP, S),
                           feats, raw.reshape(G, SP, S), cull.prims)

    _, sd, dovf = tt.nearest_hit_hybrid_feats(feats, tables, mg, 119)
    assert not bool(dovf)
    np.testing.assert_array_equal(tp.np_(slot), tp.np_(sd))
    ref = tt.nearest_hit_brute(tt.Ray(origin=torch.as_tensor(wide["o"]),
                                      direction=torch.as_tensor(wide["d"])),
                               wide["scene"])
    ids = hits(t, slot).index
    np.testing.assert_array_equal(ids, tp.np_(ref.index))
    assert (ids >= 0).mean() > 0.5
