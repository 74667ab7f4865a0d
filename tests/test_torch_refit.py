"""PyTorch port vs the JAX package: BVH refit (``tracer_torch.bvh.refit``).

The same numpy scene and tree go to ``tracer.bvh.refit`` and to the port.
The refit plan is integer data and must equal JAX's exactly; boxes are
min/max folds of the same f32 values (c - r, c + r), so they must be equal
exactly too, on the identity refit (where they also equal the build's) and
on moved geometry. The port's per-ray traversal over the refitted tree
equals brute force on the moved scene modulo grazes, and gradients of box
functionals match ``jax.grad`` to 1e-4 * max|g_JAX| + 1e-7.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tracer_torch as tt
from tests import torch_parity as tp
from tests.reference_oracle import assert_matches_brute_modulo_grazes
from tests.torch_parity import one_thread  # noqa: F401
from tracer.bvh.refit import build_refit_plan as j_plan
from tracer.bvh.refit import refit_bvh as j_refit
from tracer_torch.bvh.refit import build_refit_plan, refit_bvh
from tracer_torch.interop import refit_plan_from_numpy
from tracer_torch.intersect.traverse import nearest_hit_bvh

GRAD_RTOL = 1e-4     # of max |g_JAX|
GRAD_ATOL = 1e-7


def _world(n, world, leaf, seed):
    c, r, a = tp.scene_np(n, seed=seed, world=world)
    r = np.random.default_rng(seed + 1).uniform(0.3, 1.2, n) \
        .astype(np.float32)
    jb, tb = tp.bvhs(c, r, leaf)
    return c, r, a, jb, tb


@pytest.mark.parametrize("n,leaf", [(777, 8), (600, 4), (64, 4)])
def test_plan_and_identity_refit_match_jax_and_build(n, leaf):
    c, r, _, jb, tb = _world(n, 60.0, leaf, seed=n)
    jp = j_plan(jb)
    plan = build_refit_plan(tb)
    for f in ("levels", "level_mask", "left", "right", "leaf_ids"):
        np.testing.assert_array_equal(getattr(plan, f),
                                      tp.np_(getattr(jp, f)), err_msg=f)
    again = refit_plan_from_numpy(*(tp.np_(getattr(jp, f)) for f in
                                    ("levels", "level_mask", "left",
                                     "right", "leaf_ids")), device="cpu")
    for a, b in zip(again.level_nodes, plan.level_nodes):
        assert torch.equal(a, b)
    new = refit_bvh(tb, plan, torch.as_tensor(c), torch.as_tensor(r))
    jnew = j_refit(jb, jp, jnp.asarray(c), jnp.asarray(r))
    for f in ("node_min", "node_max"):
        np.testing.assert_array_equal(tp.np_(getattr(new, f)),
                                      tp.np_(getattr(jnew, f)), err_msg=f)
        np.testing.assert_array_equal(tp.np_(getattr(new, f)),
                                      tp.np_(getattr(tb, f)), err_msg=f)


def test_refit_tracks_moved_geometry():
    """Moved and grown spheres: boxes equal JAX's refit; the tree stays
    valid; traversal over it equals brute force on the moved scene."""
    n = 600
    c, r, a, jb, tb = _world(n, 50.0, 4, seed=1)
    rng = np.random.default_rng(2)
    c2 = (c + rng.normal(size=(n, 3)) * 2.0).astype(np.float32)
    r2 = (r * 1.3).astype(np.float32)
    new = refit_bvh(tb, build_refit_plan(tb), torch.as_tensor(c2),
                    torch.as_tensor(r2))
    jnew = j_refit(jb, j_plan(jb), jnp.asarray(c2), jnp.asarray(r2))
    for f in ("node_min", "node_max"):
        np.testing.assert_array_equal(tp.np_(getattr(new, f)),
                                      tp.np_(getattr(jnew, f)), err_msg=f)
    tt.validate_bvh(new, c2, r2)

    moved = tt.scene_from_numpy(c2, r2, a, device="cpu")
    d = rng.uniform(-1, 1, (512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = rng.uniform(-30, 30, (512, 3)).astype(np.float32)
    rays = tt.Ray(origin=torch.as_tensor(o), direction=torch.as_tensor(d))
    got = nearest_hit_bvh(rays, moved, new)
    ref = tt.nearest_hit_brute(rays, moved)
    assert int(ref.hit.sum()) > 20
    assert_matches_brute_modulo_grazes(
        _np_record(got), _np_record(ref), SimpleNamespace(origin=o,
                                                          direction=d),
        SimpleNamespace(centers=c2, radii=r2))


def _np_record(rec):
    return SimpleNamespace(t=tp.np_(rec.t), index=tp.np_(rec.index),
                           hit=tp.np_(rec.hit))


def test_refit_gradients_match_jax():
    """Gradients of the root's volume and of a weighted sum of every box
    bound, for centres and radii, against jax.grad."""
    c, r, _, jb, tb = _world(64, 20.0, 4, seed=3)
    jp, plan = j_plan(jb), build_refit_plan(tb)
    M = tb.num_nodes
    wts = np.random.default_rng(4).uniform(-1, 1, (2, M, 3)) \
        .astype(np.float32)

    def jfun(cc, rr):
        b = j_refit(jb, jp, cc, rr)
        ext = b.node_max[0] - b.node_min[0]
        return (ext[0] * ext[1] * ext[2]
                + jnp.sum(b.node_min * wts[0] + b.node_max * wts[1]))

    jg = jax.grad(jfun, argnums=(0, 1))(jnp.asarray(c), jnp.asarray(r))
    cc = torch.as_tensor(c).requires_grad_(True)
    rr = torch.as_tensor(r).requires_grad_(True)
    b = refit_bvh(tb, plan, cc, rr)
    ext = b.node_max[0] - b.node_min[0]
    (ext[0] * ext[1] * ext[2]
     + torch.sum(b.node_min * torch.as_tensor(wts[0])
                 + b.node_max * torch.as_tensor(wts[1]))).backward()
    for name, g, want in (("centers", cc.grad, jg[0]),
                          ("radii", rr.grad, jg[1])):
        g, want = tp.np_(g), tp.np_(want)
        assert np.isfinite(g).all() and np.abs(want).sum() > 0, name
        np.testing.assert_allclose(
            g, want, atol=GRAD_RTOL * np.abs(want).max() + GRAD_ATOL, rtol=0,
            err_msg=name)
