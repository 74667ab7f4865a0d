"""PyTorch port vs the JAX package: the distribution (``tracer_torch.dist``)
on eight gloo ranks on the CPU.

The JAX side runs on the virtual 8-device CPU mesh as ``tests/test_dist.py``
does, on the same seeds; its arrays go to the port as numpy. The port's
ranks are spawned once for the module (``tests/torch_dist_ranks.py``), run
every scenario, and hand back numpy results. Held here:

  * the ray-sharded brute-force query: index equal to JAX's
    ``nearest_hit_sharded``, t to 1e-5 relative (the port's brute-force
    parity, tests/test_torch_core.py), and bitwise the port's unsharded
    query; the ray-sharded leaf walk (its plain version, each rank
    preparing and escalating its own subpackets) bitwise its unsharded
    query;
  * the sharded render bitwise the port's unsharded render on noise from
    the same generator state, and against JAX ``render`` on that noise
    (pixels within 1e-5 on 99.5 %, as tests/test_torch_render.py);
  * the ring over sphere shards with the JAX test's seeds and tolerances,
    brute force and through ``build_sharded_bvh`` (whose arrays equal the
    JAX function's exactly), modulo grazes; the ring over one shard (no
    send) bitwise the unsharded brute force;
  * the mesh shapes, every rank getting the whole result, and the
    single-process ``init_distributed`` doing nothing;
  * ``nearest_hit_leafcull_t`` against JAX's, Pallas in interpret mode.
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tracer_torch as tt
from tests import torch_dist_ranks as ranks
from tests import torch_parity as tp
from tests.reference_oracle import assert_matches_brute_modulo_grazes
from tests.torch_parity import one_thread  # noqa: F401
from tracer.config import TracerConfig as JConfig
from tracer.core.types import Ray as JRay
from tracer.dist.mesh import ray_mesh as j_ray_mesh
from tracer.dist.ring import build_sharded_bvh as j_build_sharded_bvh
from tracer.dist.shard import nearest_hit_sharded as j_nearest_hit_sharded
from tracer.integrator.wavefront import render as j_render
from tracer.intersect.brute import nearest_hit_brute as j_brute
from tracer.scene.camera import Camera as JCamera
from tracer.scene.scene import benchmark_scene, random_scene

WORLD = 8
RING_BVH_SPHERES = 100_352          # the JAX test's scene, 8 shards
RENDER = (32, 16, 3, 9)             # width, height, depth, generator seed
SCENARIOS = ["sharded_brute", "sharded_leafwalk", "sharded_render",
             "ring_brute", "ring_bvh", "ring_one_shard", "mesh_shapes"]


def _rand_rays(n, span=10.0):
    """tests/test_dist.py's rays, drawn from its rng fixture's seed."""
    rng = np.random.default_rng(0)
    d = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = rng.uniform(-span, span, size=(n, 3)).astype(np.float32)
    return o, d


def _scene_np(scene):
    return tuple(tp.np_(x) for x in (scene.centers, scene.radii,
                                     scene.albedo))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every scenario's inputs, and every rank's results."""
    inputs = {
        "query_scene": _scene_np(benchmark_scene(jax.random.PRNGKey(0), 128,
                                                 world_size=40.0)),
        "query_rays": _rand_rays(256),
        "walk_scene": tp.scene_np(3000, seed=3, world=60.0),
        "walk_rays": tp.origin_rays_np(4096, seed=1),
        "render_scene": _scene_np(random_scene(jax.random.PRNGKey(5), 12)),
        "render_cfg": RENDER,
        "ring_scene": _scene_np(benchmark_scene(jax.random.PRNGKey(1), 1024,
                                                world_size=60.0)),
        "ring_rays": _rand_rays(512, span=20.0),
        "ring_bvh_scene": _scene_np(benchmark_scene(
            jax.random.PRNGKey(2), RING_BVH_SPHERES,
            world_size=1000.0))[:2],
        "ring_bvh_rays": _rand_rays(1024, span=200.0),
    }
    out = ranks.run(WORLD, SCENARIOS, inputs, tmp_path_factory.mktemp("dist"))
    return inputs, out


def _jax_rays(o, d):
    return JRay(origin=jnp.asarray(o), direction=jnp.asarray(d))


def _jax_scene(c, r, a=None):
    from tracer.scene.scene import fixed_scene
    return fixed_scene(c, r, a)


def test_sharded_nearest_hit_matches_jax(world):
    inputs, out = world
    got = out[0]["sharded_brute"]
    jscene = _jax_scene(*inputs["query_scene"])
    want = j_nearest_hit_sharded(_jax_rays(*inputs["query_rays"]), jscene,
                                 j_ray_mesh(), j_brute)
    np.testing.assert_array_equal(got["sharded"]["index"],
                                  tp.np_(want.index))
    hit = tp.np_(want.hit)
    assert hit.any() and not hit.all()
    np.testing.assert_allclose(got["sharded"]["t"][hit], tp.np_(want.t)[hit],
                               rtol=1e-5)
    for k in ("t", "index", "hit"):
        np.testing.assert_array_equal(got["sharded"][k],
                                      got["unsharded"][k])


def test_sharded_leaf_walk_equals_unsharded(world):
    _, out = world
    got = out[0]["sharded_leafwalk"]
    assert got["sharded"]["hit"].sum() > 100
    for k in ("t", "index", "hit"):
        np.testing.assert_array_equal(got["sharded"][k],
                                      got["unsharded"][k])


def test_sharded_render_bitwise_equal(world):
    _, out = world
    got = out[0]["sharded_render"]
    w, h, _, _ = RENDER
    assert got["sharded"].shape == (h, w, 3)
    np.testing.assert_array_equal(got["sharded"], got["unsharded"])


def test_sharded_render_matches_jax_render(world):
    inputs, out = world
    got = out[0]["sharded_render"]
    w, h, depth, _ = RENDER
    want = j_render(_jax_scene(*inputs["render_scene"]), JCamera.default(),
                    None, lambda s: (lambda r: j_brute(r, s)),
                    JConfig(width=w, height=h, max_depth=depth),
                    noise=jnp.asarray(got["noise"]))
    close = (np.abs(got["sharded"] - tp.np_(want)) <= 1e-5).all(-1)
    assert close.mean() >= 0.995, close.mean()


def test_ring_scene_sharding_equals_brute(world):
    inputs, out = world
    got = out[0]["ring_brute"]
    ref = j_brute(_jax_rays(*inputs["ring_rays"]),
                  _jax_scene(*inputs["ring_scene"]))
    hit = tp.np_(ref.hit)
    np.testing.assert_array_equal(got["hit"], hit)
    np.testing.assert_allclose(got["t"][hit], tp.np_(ref.t)[hit], rtol=1e-4)
    np.testing.assert_array_equal(got["index"][hit], tp.np_(ref.index)[hit])


def test_ring_bvh_scene_sharding_equals_brute(world):
    inputs, out = world
    got = out[0]["ring_bvh"]
    c, r = inputs["ring_bvh_scene"]
    o, d = inputs["ring_bvh_rays"]
    ref = j_brute(_jax_rays(o, d), _jax_scene(c, r))
    assert tp.np_(ref.hit).sum() > 10
    assert_matches_brute_modulo_grazes(
        SimpleNamespace(**got), ref, SimpleNamespace(origin=o, direction=d),
        SimpleNamespace(centers=c, radii=r))


def test_build_sharded_bvh_equals_jax(world):
    inputs, out = world
    got = out[0]["ring_bvh"]
    want = j_build_sharded_bvh(*inputs["ring_bvh_scene"], num_shards=WORLD,
                               leaf_size=8)
    assert got["sbvh_sizes"] == (want.shard_size, want.leaf_size)
    for k, v in got["sbvh"].items():
        w = tp.np_(getattr(want, k))
        assert v.dtype == w.dtype and v.shape == w.shape, k
        np.testing.assert_array_equal(v, w, err_msg=k)


def test_ring_one_shard_equals_unsharded_brute(world):
    _, out = world
    got = out[0]["ring_one_shard"]
    for k in ("t", "index", "hit"):
        np.testing.assert_array_equal(got["brute"][k], got["ref"][k])
        np.testing.assert_array_equal(got["bvh"][k], got["ref"][k])


def test_2d_mesh_shapes(world):
    _, out = world
    for rank, res in enumerate(out):
        got = res["mesh_shapes"]
        shape, names, rays, scene = got["default"]
        assert shape == (4, 2) and names == ("rays", "scene")
        assert rays == [rank % 2 + 2 * i for i in range(4)]
        assert scene == [rank - rank % 2, rank - rank % 2 + 1]
        assert got["rays4"][0] == (4, 2) and got["scene4"][0] == (2, 4)
        assert got["8x1"][0] == (8, 1) and got["8x1"][3] == [rank]
        assert got["ray"] == ((8,), ("rays",))
        assert got["ray2_coordinate"] == ((rank,) if rank < 2 else None)


def test_every_rank_gets_the_whole_result(world):
    _, out = world
    for res in out[1:]:
        for name in ("sharded_brute", "sharded_leafwalk", "ring_brute",
                     "ring_bvh"):
            a = out[0][name].get("sharded", out[0][name])
            b = res[name].get("sharded", res[name])
            for k in ("t", "index", "hit"):
                np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(out[0]["sharded_render"]["sharded"],
                                      res["sharded_render"]["sharded"])


def test_init_distributed_single_process_is_a_no_op(monkeypatch):
    import torch.distributed as dist
    from tracer_torch.dist import init_distributed
    for k in ("TRACER_NUM_PROCESSES", "TRACER_COORDINATOR"):
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()
    assert init_distributed(device="cpu") == 1
    assert init_distributed(num_processes=1, device="cpu") == 1
    monkeypatch.setenv("TRACER_NUM_PROCESSES", "1")
    assert init_distributed(device="cpu") == 1
    assert not dist.is_initialized()


def test_dist_modules_never_import_jax():
    code = ("import sys\n"
            "import tracer_torch.dist, tracer_torch.bench.scaling\n"
            "import tests.torch_dist_ranks\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith(('jax.', 'tracer.'))\n"
            "             or m in ('tracer', 'jaxlib', 'flax',\n"
            "                      'tests.conftest'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


# ---------------------------------------------------------------------------
# nearest_hit_leafcull_t, the closest hit straight from the leaf walk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mc", [119, 5])
def test_nearest_hit_leafcull_t_matches_jax(mc):
    """Sorted origin rays at leaf 8, packets of two 64-ray subpackets (the
    interpret-mode kernel's trace grows with the subpackets), with the
    default budgets and with a
    leaf budget of 5 (group-mode rows): ids and overflow equal JAX's, t to
    the leaf walk's tolerance against JAX (``tp.assert_ray_t_close``: 1e-5
    relative but at grazes); the port's ids also equal its own HitRecord
    query's."""
    from tracer.kernels import conecull as jcone
    from tracer.kernels.leafcull import nearest_hit_leafcull_t as j_lite
    c, r, a = tp.scene_np(600, seed=3)
    jscene, tscene = tp.scenes(c, r, a)
    jb, tb = tp.bvhs(c, r, 8)
    jt = jcone.build_cone_tables(jscene, jb)
    t_tables = tt.build_cone_tables(tscene, tb)
    o, d = tp.origin_rays_np(512)
    rays, _ = tt.sort_rays_octahedral(tt.Ray(torch.as_tensor(o),
                                             torch.as_tensor(d)))
    o, d = tp.np_(rays.origin), tp.np_(rays.direction)
    t, sid, ovf = tt.nearest_hit_leafcull_t(rays, t_tables.cull,
                                            max_candidates=mc, subpackets=2)
    jt_, jsid, jovf = j_lite(_jax_rays(o, d), jt.cull, max_candidates=mc,
                             subpackets=2, interpret=True)
    np.testing.assert_array_equal(tp.np_(sid), tp.np_(jsid))
    assert bool(ovf) == bool(jovf)
    hit = tp.np_(sid) >= 0
    assert hit.sum() > 10
    tp.assert_ray_t_close(t, jt_, o, d, sid, c, r)
    assert np.isinf(tp.np_(t)[~hit]).all()
    if not bool(ovf):
        rec, _ = tt.nearest_hit_leafcull(rays, tscene, t_tables)
        np.testing.assert_array_equal(tp.np_(sid), tp.np_(rec.index))
