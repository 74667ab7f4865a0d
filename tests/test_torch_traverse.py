"""PyTorch port vs the JAX package: the packet walk and the per-ray walk.

``traverse_call`` on CPU tensors runs ``traverse_plain``, the plain version
of the CUDA kernel ``traverse_cuda``. It is held against JAX
``_traverse_packets`` (Pallas, in interpret mode) on the same packed rays
and tables: slots and steps exactly, t within f32 rounding (XLA on the CPU
contracts mul+add into FMA where the port rounds each op, which moves t by
an ulp or so, more on grazing rays), also on a packet that spans the scene
beside parked rays, as compacted bounce rays are. The walk cut at step caps
and resumed from its state equals the whole walk, as the kernel's two
launches need. The HitRecord wrappers are held against their JAX
counterparts, and autograd through the recomputed t against ``jax.grad``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tracer_torch as tt
from tests import torch_parity as tp
from tests.torch_parity import one_thread  # noqa: F401
from tracer.core.types import Ray as JRay
from tracer.intersect.sphere import ray_sphere_t as j_ray_sphere_t
from tracer.intersect.traverse import nearest_hit_bvh as j_nearest_bvh
from tracer.kernels.traverse_pallas import (_traverse_packets,
                                            nearest_hit_bvh_pallas,
                                            pack_bvh as j_pack_bvh)
from tracer_torch.intersect.traverse import nearest_hit_bvh
from tracer_torch.kernels.traverse import (PACKET, nearest_hit_bvh_packets,
                                           pack_bvh, pack_rays, traverse_call,
                                           traverse_plain)


def _rays_np(b, span, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(b, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = rng.uniform(-span, span, (b, 3)).astype(np.float32)
    return o, d


def _setup(n, world, leaf_size, seed=5):
    c, r, a = tp.scene_np(n, seed=seed, world=world)
    jscene, tscene = tp.scenes(c, r, a)
    jb, tb = tp.bvhs(c, r, leaf_size)
    return jscene, tscene, jb, tb


def _jax_packed_rays(o, d):
    """The JAX wrapper's packing: edge padding, (g, 6, 8, 128)."""
    b = o.shape[0]
    g = -(-b // PACKET)
    pad = g * PACKET - b

    def pack(x):
        x = jnp.pad(jnp.asarray(x), ((0, pad), (0, 0)), mode="edge")
        return x.reshape(g, 8, 128, 3).transpose(0, 3, 1, 2)
    return jnp.concatenate([pack(o), pack(d)], axis=1)


def _assert_record_t_close(rec, jrec, o, d, scene):
    """HitRecord t against JAX's at the (equal) hit ids."""
    hit = tp.np_(rec.hit).reshape(-1)
    idx = tp.np_(rec.index).reshape(-1)[hit]
    tp.assert_sphere_t_close(tp.np_(rec.t).reshape(-1)[hit],
                             tp.np_(jrec.t).reshape(-1)[hit],
                             o.reshape(-1, 3)[hit], d.reshape(-1, 3)[hit],
                             tp.np_(scene.centers)[idx],
                             tp.np_(scene.radii)[idx] ** 2)


@pytest.mark.parametrize("n,world,span,leaf_size,nrays", [
    (300, 40.0, 0.0, 16, PACKET + 129),     # ragged tail, origin rays
    (900, 80.0, 20.0, 8, 2 * PACKET),       # origins spread, two packets
])
def test_traverse_plain_matches_jax_kernel(n, world, span, leaf_size, nrays):
    jscene, tscene, jb, tb = _setup(n, world, leaf_size)
    o, d = _rays_np(nrays, span, seed=n)
    jpacked = j_pack_bvh(jscene, jb)
    jt, jslot, jsteps = _traverse_packets(_jax_packed_rays(o, d), jpacked,
                                          interpret=True)
    packed = pack_bvh(tscene, tb)
    rays, g, pad = pack_rays(torch.as_tensor(o), torch.as_tensor(d))
    assert (g, pad) == (jslot.shape[0], g * PACKET - nrays)
    t, slot, steps = traverse_call(rays, packed)
    np.testing.assert_array_equal(tp.np_(slot).reshape(-1),
                                  tp.np_(jslot).reshape(-1))
    np.testing.assert_array_equal(tp.np_(steps),
                                  tp.np_(jsteps)[:, 0, 0])
    assert (tp.np_(jsteps) == tp.np_(jsteps)[:, :1, :1]).all()
    s = tp.np_(slot).reshape(-1)
    assert (s >= 0).sum() > 50                # the case exercises hits
    r = tp.np_(rays).reshape(-1, 8)
    hit = s >= 0
    q = tp.np_(packed.prims)[s[hit]]
    tp.assert_sphere_t_close(tp.np_(t).reshape(-1)[hit],
                             tp.np_(jt).reshape(-1)[hit], r[hit, 0:3],
                             r[hit, 3:6], q[:, :3], q[:, 3])
    # Leaf visits: at most steps, at least one per packet with a hit.
    _, _, steps2, leaves = traverse_plain(rays, packed, leaf_visits=True)
    assert torch.equal(steps2, steps)
    assert bool((leaves <= steps).all()) and bool((leaves > 0).all())


def _spanning_rays(b, live, world, seed):
    """b rays of which ``live`` (random positions) have origins spread
    through the scene and random directions; the rest are parked as the
    wavefront integrator parks finished rays (origin 1e18, direction +x)."""
    rng = np.random.default_rng(seed)
    o = np.full((b, 3), 1e18, np.float32)
    d = np.zeros((b, 3), np.float32)
    d[:, 0] = 1.0
    idx = rng.choice(b, live, replace=False)
    lo, ld = _rays_np(live, world / 2, seed + 1)
    o[idx], d[idx] = lo, ld
    return o, d


@pytest.mark.parametrize("leaf_size,live", [(4, 700), (16, 1100)])
def test_scene_spanning_packet_matches_jax_kernel(leaf_size, live):
    """Live rays with origins all over the scene and random directions,
    mixed with parked rays, in a full packet and a ragged one: the live
    rays' union of nodes is most of the tree, the parked rays miss the
    root. Slots and steps exactly, t to f32 rounding."""
    jscene, tscene, jb, tb = _setup(500, 20.0, leaf_size, seed=9)
    nrays = PACKET + 371
    o, d = _spanning_rays(nrays, live, 20.0, seed=leaf_size)
    jpacked = j_pack_bvh(jscene, jb)
    jt, jslot, jsteps = _traverse_packets(_jax_packed_rays(o, d), jpacked,
                                          interpret=True)
    packed = pack_bvh(tscene, tb)
    rays, g, _ = pack_rays(torch.as_tensor(o), torch.as_tensor(d))
    t, slot, steps, leaves = traverse_plain(rays, packed, leaf_visits=True)
    np.testing.assert_array_equal(tp.np_(slot).reshape(-1),
                                  tp.np_(jslot).reshape(-1))
    np.testing.assert_array_equal(tp.np_(steps), tp.np_(jsteps)[:, 0, 0])
    s = tp.np_(slot).reshape(-1)
    parked = np.zeros(g * PACKET, bool)
    parked[:nrays] = o[:, 0] >= 1e17
    parked[nrays:] = parked[nrays - 1]
    assert (s[parked] == -1).all() and (s[~parked] >= 0).sum() > 100
    # Most of the tree is visited, and leaves of every part of it tested.
    assert (tp.np_(steps) > packed.num_nodes // 2).all()
    assert (tp.np_(leaves) > 20).all()
    r = tp.np_(rays).reshape(-1, 8)
    hit = s >= 0
    q = tp.np_(packed.prims)[s[hit]]
    tp.assert_sphere_t_close(tp.np_(t).reshape(-1)[hit],
                             tp.np_(jt).reshape(-1)[hit], r[hit, 0:3],
                             r[hit, 3:6], q[:, :3], q[:, 3])


@pytest.fixture(scope="module")
def spanning_walk():
    """Three packets of 500 spheres in leaves of 8: one scene-spanning,
    one of parked rays, one coherent from the origin; and the whole walk."""
    c, r, a = tp.scene_np(500, seed=4, world=60.0)
    _, tscene = tp.scenes(c, r, a)
    packed = pack_bvh(tscene, tp.bvhs(c, r, 8)[1])
    o, d = _spanning_rays(2 * PACKET, 600, 60.0, seed=3)
    o[:PACKET] = _spanning_rays(PACKET, 900, 60.0, seed=5)[0]
    o[PACKET:], d[PACKET:] = np.float32(1e18), np.float32([1.0, 0.0, 0.0])
    oc, dc = _rays_np(PACKET, 0.0, seed=6)
    dc = dc * np.float32(0.05) + np.float32([1.0, 0.0, 0.0])
    dc /= np.linalg.norm(dc, axis=1, keepdims=True)
    rays, _, _ = pack_rays(torch.as_tensor(np.concatenate([o, oc])),
                           torch.as_tensor(np.concatenate([d, dc])))
    return rays, packed, traverse_plain(rays, packed, leaf_visits=True)


@pytest.mark.parametrize("caps", [(1,), (2, 9), (40,), (5, 60, 61, 150),
                                  (10 ** 6,)])
def test_walk_cut_at_caps_and_resumed_equals_whole_walk(spanning_walk,
                                                        caps):
    """t, slots, steps and leaf visits bit for bit, whatever the caps: a
    cap of one step, caps inside the spanning packet's walk, consecutive
    caps, and a cap no packet reaches."""
    rays, packed, whole = spanning_walk
    steps = whole[2]
    assert int(steps[1]) == 1
    assert int(steps[0]) > max(packed.num_nodes // 2, int(steps[2]), 61)
    got = traverse_plain(rays, packed, leaf_visits=True, caps=caps)
    for x, y in zip(got, whole):
        assert torch.equal(x, y)


def test_packed_tables_match_jax():
    jscene, tscene, jb, tb = _setup(200, 30.0, 8)
    jp = j_pack_bvh(jscene, jb)
    p = pack_bvh(tscene, tb)
    M = jp.num_nodes
    nodes = tp.np_(jp.nodes).transpose(0, 2, 1).reshape(-1, 8)[:M]
    np.testing.assert_array_equal(tp.np_(p.nodes)[:, [0, 1, 2, 4, 5, 6]],
                                  nodes[:, :6])
    for name in ("esc", "nxt", "lstart"):
        np.testing.assert_array_equal(tp.np_(getattr(p, name)),
                                      tp.np_(getattr(jp, name)))
    P = p.prims.shape[0]
    prims = tp.np_(jp.prims).transpose(0, 2, 1).reshape(-1, 8)[:P, :4]
    np.testing.assert_array_equal(tp.np_(p.prims), prims)
    np.testing.assert_array_equal(tp.np_(p.prim_idx), tp.np_(jp.prim_idx))
    assert (p.num_nodes, p.leaf_size) == (jp.num_nodes, jp.leaf_size)


@pytest.mark.parametrize("shape", [(PACKET + 129,), (24, 50)])
def test_nearest_hit_bvh_packets_matches_jax(shape):
    jscene, tscene, jb, tb = _setup(400, 50.0, 16)
    b = int(np.prod(shape))
    o, d = _rays_np(b, 10.0, seed=b)
    o, d = o.reshape(*shape, 3), d.reshape(*shape, 3)
    jrec, jsteps = nearest_hit_bvh_pallas(
        JRay(origin=jnp.asarray(o), direction=jnp.asarray(d)), jscene,
        j_pack_bvh(jscene, jb), interpret=True, with_steps=True)
    rec, steps = nearest_hit_bvh_packets(
        tt.Ray(origin=torch.as_tensor(o), direction=torch.as_tensor(d)),
        tscene, pack_bvh(tscene, tb), with_steps=True)
    assert tuple(rec.t.shape) == shape and tuple(steps.shape) == shape
    np.testing.assert_array_equal(tp.np_(rec.index), tp.np_(jrec.index))
    np.testing.assert_array_equal(tp.np_(steps), tp.np_(jsteps))
    hit = tp.np_(rec.hit)
    np.testing.assert_array_equal(hit, tp.np_(jrec.hit))
    assert hit.sum() > 20
    _assert_record_t_close(rec, jrec, o, d, tscene)
    np.testing.assert_allclose(tp.np_(rec.normal)[hit],
                               tp.np_(jrec.normal)[hit], atol=1e-4)


@pytest.mark.parametrize("leaf_size", [4, 16])
def test_nearest_hit_bvh_matches_jax_traversal(leaf_size):
    jscene, tscene, jb, tb = _setup(500, 60.0, leaf_size)
    o, d = _rays_np(700, 15.0, seed=leaf_size)
    jrec = j_nearest_bvh(JRay(origin=jnp.asarray(o), direction=jnp.asarray(d)),
                         jscene, jb)
    rec = nearest_hit_bvh(tt.Ray(origin=torch.as_tensor(o),
                                 direction=torch.as_tensor(d)), tscene, tb)
    np.testing.assert_array_equal(tp.np_(rec.index), tp.np_(jrec.index))
    hit = tp.np_(rec.hit)
    assert hit.sum() > 20
    _assert_record_t_close(rec, jrec, o, d, tscene)
    ref = tt.nearest_hit_brute(tt.Ray(origin=torch.as_tensor(o),
                                      direction=torch.as_tensor(d)), tscene)
    np.testing.assert_array_equal(tp.np_(rec.index), tp.np_(ref.index))


@pytest.mark.parametrize("walk", ["packets", "per_ray"])
def test_gradients_match_jax_grad(walk):
    """d(sum of hit t)/d(centers) through the recomputed t, 64 spheres x
    256 rays, against jax.grad (rtol 1e-4). The JAX packet wrapper
    recomputes t outside its kernel, so jax.grad goes through it; the JAX
    per-ray walk keeps t from inside a while_loop, which reverse mode does
    not reach, so its reference is jax.grad of ``ray_sphere_t`` at the ids
    that walk chose."""
    c, r, a = tp.scene_np(64, seed=11, world=16.0)
    r = np.full_like(r, 1.5)
    jscene, tscene = tp.scenes(c, r, a)
    jb, tb = tp.bvhs(c, r, 16)
    o, d = _rays_np(256, 2.0, seed=12)
    jrays = JRay(origin=jnp.asarray(o), direction=jnp.asarray(d))
    jpacked = j_pack_bvh(jscene, jb)

    if walk == "packets":
        def loss(centers):
            rec = nearest_hit_bvh_pallas(
                jrays, jscene.replace(centers=centers), jpacked,
                interpret=True)
            return jnp.sum(jnp.where(rec.hit, rec.t, 0.0))
    else:
        jidx = j_nearest_bvh(jrays, jscene, jb).index
        safe = jnp.maximum(jidx, 0)

        def loss(centers):
            t = j_ray_sphere_t(jrays.origin, jrays.direction, centers[safe],
                               jscene.radii[safe])
            return jnp.sum(jnp.where((jidx >= 0) & jnp.isfinite(t), t, 0.0))

    jgrad = tp.np_(jax.grad(loss)(jscene.centers))
    centers = tscene.centers.clone().requires_grad_(True)
    s = tt.Scene(centers=centers, radii=tscene.radii, albedo=tscene.albedo)
    rays = tt.Ray(origin=torch.as_tensor(o), direction=torch.as_tensor(d))
    rec = (nearest_hit_bvh_packets(rays, s, pack_bvh(tscene, tb))
           if walk == "packets" else nearest_hit_bvh(rays, s, tb))
    assert int(rec.hit.sum()) > 30
    torch.where(rec.hit, rec.t, torch.zeros_like(rec.t)).sum().backward()
    grad = tp.np_(centers.grad)
    assert np.abs(grad).sum() > 0
    np.testing.assert_allclose(grad, jgrad, rtol=1e-4, atol=1e-6)
