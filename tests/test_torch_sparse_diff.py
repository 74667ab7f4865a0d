"""PyTorch port vs the JAX package: the BVH-sparsified soft renderer
(``tracer_torch.diff.sparse``) and its phase A (``leaf_candidates``).

Both sides take the same numpy scene, tree (built from radii inflated by
``soft_radius_scale``) and padded rays. Integer outputs are held exactly:
``leaf_candidates`` rows and overflow (leaf mode, group mode, an
overflowing scene, C > 1 chunks; the port compacts where JAX sorts),
candidate leaf and sphere ids, and the leaf-order path's per-subpacket
leaf order. The images and gradients of the packets, leaf-order and top-M
paths are held against the JAX functions run in float64 on the same
f32-valued scene and rays (``torch_parity.x64``): the port's perp2 is the
length of the perpendicular vector, JAX's f32 |oc|^2 - t_ca^2 |d|^2
cancels. Bounds: images atol 1e-5, gradients 1e-4 * max|g_JAX| + 1e-7.
Measured on this file's scene: the port's f32 misses float64 by up to
5.1e-6 in the image and 3.1e-5 of the largest gradient (radii); JAX's f32
misses it by 4.4e-4 and 2.7e-3 (the top-M selection is exact on both
sides here). The port's sparse image
is held against its own dense image with the JAX test's bound (5e-3,
tests/test_sparse_diff.py), and every gradient must be finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tracer_torch as tt
from tests import torch_parity as tp
from tests.torch_parity import one_thread  # noqa: F401
from tracer.core.sort import prep_rays_bucketed as j_prep_rays
from tracer.core.types import Ray as JRay
from tracer.diff import soft as jsoft
from tracer.diff import sparse as jsparse
from tracer.kernels import leafcull as jleaf
from tracer_torch.diff import soft, sparse
from tracer_torch.kernels.leafcull import leaf_candidates

SP = 64
CELL_BITS = 4
IMG_ATOL = 1e-5     # against JAX in float64
GRAD_RTOL = 1e-4     # of max |g_JAX|
GRAD_ATOL = 1e-7
# case -> (scene, unsorted rays?, max_groups, max_candidates)
ROW_CASES = {
    "leaf_mode": ("small", False, 48, 64),
    "group_mode": ("small", False, 48, 2),
    "group_budget": ("small", False, 2, 64),
    "chunked": ("chunked", False, 48, 16),
    "overflow": ("large", True, 48, 4),
}


def _tables(n, world, leaf, seed, **kw):
    """(JAX scene, port scene, JAX tables, port tables, inflation) of n
    spheres: the tree built from radii inflated for the default soft
    params, the tables from the scene's own radii."""
    c, r, a = tp.scene_np(n, seed=seed, world=world)
    jscene, tscene = tp.scenes(c, r, a)
    scale = sparse.soft_radius_scale(soft.SoftParams())
    jb, tb = tp.bvhs(c, r * np.float32(scale), leaf)
    return (jscene, tscene,
            jleaf.build_cull_tables(jscene, jb, leaves_per_group=16, **kw),
            tt.build_cull_tables(tscene, tb, leaves_per_group=16, **kw))


def _rays(n, span, seed, unsorted=False):
    """n random rays, sorted and bucket-padded by the JAX prep (or left
    unsorted, padded to whole subpackets): (o, d) numpy (Bp, 3)."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = rng.uniform(-span, span, (n, 3)).astype(np.float32)
    if unsorted:
        return o, d
    padded, _ = j_prep_rays(JRay(origin=jnp.asarray(o),
                                 direction=jnp.asarray(d)), SP,
                            cell_bits=CELL_BITS)
    return tp.np_(padded.origin), tp.np_(padded.direction)


def _scene64(jscene):
    """A JAX scene's arrays in float64 (inside ``tp.x64``)."""
    return tp.scene64(jscene.centers, jscene.radii, jscene.albedo)


@pytest.fixture(scope="module")
def world():
    small = _tables(300, 50.0, 8, seed=2)
    chunked = _tables(300, 50.0, 8, seed=2, max_chunk_bytes=48 * 1024)
    large = _tables(4000, 120.0, 2, seed=5)
    return {"small": small, "chunked": chunked, "large": large,
            "rays": _rays(512, 10.0, seed=0),
            "unsorted": _rays(512, 0.0, seed=1, unsorted=True)}


def _case(world, case):
    key, unsorted, mg, mc = ROW_CASES[case]
    o, d = world["unsorted" if unsorted else "rays"]
    return world[key], o, d, mg, mc


@pytest.mark.parametrize("case", sorted(ROW_CASES))
def test_leaf_candidates_rows_match_jax(world, case):
    (_, _, jt, tt_), o, d, mg, mc = _case(world, case)
    jrows, jovf = jleaf.leaf_candidates(jnp.asarray(o), jnp.asarray(d), jt,
                                        mg, mc, SP)
    rows, ovf = leaf_candidates(torch.as_tensor(o), torch.as_tensor(d), tt_,
                                mg, mc, SP)
    want = tp.np_(jrows)
    assert rows.dtype == torch.int32
    np.testing.assert_array_equal(tp.np_(rows), want)
    assert bool(ovf) == bool(jovf) == (case == "overflow")
    if case in ("group_mode", "group_budget", "overflow"):
        assert (want[..., 0] < 0).any()
    if case == "leaf_mode":
        assert (want[..., 0] >= 0).all() and (want[..., 0] > 8).any()
    if case == "chunked":
        assert want.shape[0] > 1


@pytest.mark.parametrize("case", ["leaf_mode", "group_mode", "group_budget"])
def test_candidate_ids_match_jax(world, case):
    (_, _, jt, tt_), o, d, mg, mc = _case(world, case)
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    to, td = torch.as_tensor(o), torch.as_tensor(d)
    jl, jv, jovf = jsparse.candidate_leaf_ids(jo, jd, jt, mg, mc, SP)
    tl, tv, tovf = sparse.candidate_leaf_ids(to, td, tt_, mg, mc, SP)
    np.testing.assert_array_equal(tp.np_(tl), tp.np_(jl))
    np.testing.assert_array_equal(tp.np_(tv), tp.np_(jv))
    assert bool(tovf) == bool(jovf)
    jids, jovf2 = jsparse.candidate_sphere_ids(jo, jd, jt, mg, mc, SP)
    ids, tovf2 = sparse.candidate_sphere_ids(to, td, tt_, mg, mc, SP)
    np.testing.assert_array_equal(tp.np_(ids), tp.np_(jids))
    assert bool(tovf2) == bool(jovf2)
    assert (tp.np_(ids) >= 0).any()


def test_leaf_order_matches_jax(world):
    """The leaf-order path's per-subpacket order: JAX's stable
    ``lax.sort`` of the projected leaf centres, spelled out as in
    tracer/diff/sparse.py, against the port's ``leaf_order``."""
    _, _, jt, tt_ = world["small"]
    o, d = world["rays"]
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    jl, jv, _ = jsparse.candidate_leaf_ids(jo, jd, jt, 48, 64, SP)
    P = jl.shape[0]
    op, dp = jo.reshape(P, SP, 3), jd.reshape(P, SP, 3)
    lc = 0.5 * (jt.leaf_min + jt.leaf_max)
    key = jnp.sum((lc[jl] - jnp.mean(op, 1)[:, None])
                  * jnp.mean(dp, 1)[:, None], axis=2)
    key = jnp.where(jv, key, 3.0e38)
    _, jl_s, jv_s = jax.lax.sort((key, jl, jv.astype(jnp.int32)),
                                 dimension=1, num_keys=1)
    tl, tv, _ = sparse.candidate_leaf_ids(torch.as_tensor(o),
                                          torch.as_tensor(d), tt_, 48, 64, SP)
    tl_s, tv_s = sparse.leaf_order(torch.as_tensor(o), torch.as_tensor(d),
                                   tt_, tl, tv, SP)
    np.testing.assert_array_equal(tp.np_(tl_s), tp.np_(jl_s))
    np.testing.assert_array_equal(tp.np_(tv_s), tp.np_(jv_s) > 0)
    assert (tp.np_(jv).sum(1) > 1).sum() >= 8


PATHS = {
    "packets": (jsparse.soft_render_sparse_packets,
                sparse.soft_render_sparse_packets, {}),
    "leaforder": (jsparse.soft_render_sparse_leaforder,
                  sparse.soft_render_sparse_leaforder, {}),
    "fast": (jsparse.soft_render_sparse_fast,
             sparse.soft_render_sparse_fast, {"top_m": 16}),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_sparse_images_and_gradients_match_jax(world, path):
    """Image and d(mean((img - 0.3)^2))/d(centres, radii, albedo) of each
    sparse path against JAX on the same padded rays (max_leaves 64)."""
    jscene, tscene, jt, tt_ = world["small"]
    o, d = world["rays"]
    jfn, tfn, kw = PATHS[path]
    jp = jsoft.SoftParams()

    with tp.x64():
        s64 = _scene64(jscene)

        def jloss(centers, radii, albedo):
            s = s64.replace(centers=centers, radii=radii, albedo=albedo)
            img, ovf = jfn(s, tp.f64(o), tp.f64(d), jt, jp,
                           max_leaves=64, subpacket=SP, **kw)
            return jnp.mean((img - 0.3) ** 2), (img, ovf)

        (_, (jimg, jovf)), jgrads = jax.value_and_grad(
            jloss, argnums=(0, 1, 2), has_aux=True)(
                s64.centers, s64.radii, s64.albedo)
        assert jimg.dtype == jnp.float64
    args = [x.clone().requires_grad_(True)
            for x in (tscene.centers, tscene.radii, tscene.albedo)]
    img, ovf = tfn(tt.Scene(*args), torch.as_tensor(o), torch.as_tensor(d),
                   tt_, soft.SoftParams(), max_leaves=64, subpacket=SP, **kw)
    assert not bool(ovf) and not bool(jovf)
    np.testing.assert_allclose(tp.np_(img), tp.np_(jimg), atol=IMG_ATOL,
                               rtol=0)
    torch.mean((img - 0.3) ** 2).backward()
    for name, t, g in zip(("centers", "radii", "albedo"), args, jgrads):
        g = tp.np_(g)
        got = tp.np_(t.grad)
        assert np.isfinite(got).all() and np.abs(g).max() > 0, name
        np.testing.assert_allclose(
            got, g, atol=GRAD_RTOL * np.abs(g).max() + GRAD_ATOL, rtol=0,
            err_msg=name)


def test_sparse_matches_own_dense_and_stays_finite(world):
    """The port's sparse image (caller's ray order, its own prep) against
    its dense image at the JAX test's bound, atol 5e-3, with 32 leaves a
    subpacket (no overflow here); gradients for centres, radii, albedo and
    camera yaw finite and not all zero; and a budget of 2 leaves flags
    overflow."""
    _, tscene, _, tt_ = world["small"]
    rng = np.random.default_rng(6)
    d = rng.uniform(-1, 1, (256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = rng.uniform(-10, 10, (256, 3)).astype(np.float32)
    rays = tt.Ray(origin=torch.as_tensor(o), direction=torch.as_tensor(d))
    params = soft.SoftParams()
    args = [x.clone().requires_grad_(True)
            for x in (tscene.centers, tscene.radii, tscene.albedo)]
    s = tt.Scene(*args)
    img, ovf = sparse.soft_render_sparse(s, rays, tt_, params, max_leaves=32)
    assert not bool(ovf)
    with torch.no_grad():
        dense = soft.soft_render(tscene, None, params, rays=rays)
    np.testing.assert_allclose(tp.np_(img), tp.np_(dense), atol=5e-3)
    torch.mean(img ** 2).backward()
    for name, t in zip(("centers", "radii", "albedo"), args):
        g = tp.np_(t.grad)
        assert np.isfinite(g).all() and np.abs(g).max() > 0, name

    cam = tt.Camera.default("cpu")
    yaw = cam.yaw.clone().requires_grad_(True)
    cfg = tt.TracerConfig(width=16, height=12)
    cimg, _ = sparse.soft_render_sparse(
        tscene, tt.camera_rays(cam.replace(yaw=yaw), cfg), tt_, params,
        max_leaves=32)
    torch.mean(cimg).backward()
    assert torch.isfinite(yaw.grad)

    _, ovf2 = sparse.soft_render_sparse(tscene, rays, tt_, params,
                                        max_leaves=2)
    assert bool(ovf2)


def test_leaforder_deviation_is_the_references():
    """On a scene dense enough that soft silhouettes overlap along rays
    (300 spheres in a 24-unit cube, 32-sphere leaves, 512 sorted origin
    rays), the leaf-order composite's shared per-subpacket order deviates
    from the exact composite by far more than the 4e-3 that
    tests/test_sparse_diff.py sees on its scene, in the JAX function (run
    in float64) as in the port, and the port's leaf-order and packets
    images stay within IMG_ATOL of JAX's: the deviation is the model's,
    not the port's."""
    c, r, a = tp.scene_np(300, seed=2, world=24.0)
    jscene, tscene = tp.scenes(c, r, a)
    scale = sparse.soft_radius_scale(soft.SoftParams())
    jb, tb = tp.bvhs(c, r * np.float32(scale), 32)
    jt = jleaf.build_cull_tables(jscene, jb, leaves_per_group=16)
    t_ = tt.build_cull_tables(tscene, tb, leaves_per_group=16)
    o, d = tp.origin_rays_np(4096, seed=0)
    padded, _ = j_prep_rays(JRay(origin=jnp.asarray(o),
                                 direction=jnp.asarray(d)), SP,
                            cell_bits=CELL_BITS)
    jo, jd = padded.origin[:512], padded.direction[:512]
    to, td = tp.to_torch(jo), tp.to_torch(jd)
    jp, tparams = jsoft.SoftParams(), soft.SoftParams()

    # Op by op, as the JAX tests run them: compiled whole, XLA's fusions
    # round t and the leaf keys otherwise, which reorders near ties.
    with tp.x64():
        s64 = _scene64(jscene)
        jo64, jd64 = tp.f64(jo), tp.f64(jd)
        jpk, _ = jsparse.soft_render_sparse_packets(s64, jo64, jd64, jt, jp,
                                                    max_leaves=64)
        jlo, jovf = jsparse.soft_render_sparse_leaforder(s64, jo64, jd64, jt,
                                                         jp, max_leaves=64)
    tpk, _ = sparse.soft_render_sparse_packets(tscene, to, td, t_, tparams,
                                               max_leaves=64)
    tlo, tovf = sparse.soft_render_sparse_leaforder(tscene, to, td, t_,
                                                    tparams, max_leaves=64)
    assert not bool(jovf) and not bool(tovf)
    np.testing.assert_allclose(tp.np_(tlo), tp.np_(jlo), atol=IMG_ATOL,
                               rtol=0)
    np.testing.assert_allclose(tp.np_(tpk), tp.np_(jpk), atol=IMG_ATOL,
                               rtol=0)
    jdev = np.abs(tp.np_(jlo) - tp.np_(jpk)).max()
    tdev = np.abs(tp.np_(tlo) - tp.np_(tpk)).max()
    assert jdev > 0.1 and abs(tdev - jdev) <= 2 * IMG_ATOL
