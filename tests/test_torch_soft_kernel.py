"""The soft evaluation's hand-written composite and backward on the CPU:
the plain version of ``csrc/soft.cu`` (``diff.sparse.soft_composite_plain``
and ``soft_backward_plain``) against autograd over the oracle
``diff.sparse._soft_block``, block by block, and the kernel wrapper's
guards.

Bounds, plain version against autograd, both in float32 on one thread:
image 2e-6 absolute and loss 1e-6 relative (the exclusive prefix is a
shifted cumsum where the oracle subtracts each term from the inclusive
one, so w and the sums round in another order: a few ulps of 1; measured
3.6e-7 and 0); gradients 1e-5 relative L2 (the hand-written chain rule
multiplies the same factors in another order than autograd, and the
reverse scan sums R in another order than autograd's cumsum backward;
measured 5e-7). Ties (a ray through a centre, channels on the clip's
bounds, equal t) are decided on values both compute in the same
operations, so they take the same half gradients."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import tracer_torch as tt
from tests.torch_parity import one_thread  # noqa: F401
from tracer_torch.diff import sparse
from tracer_torch.diff.soft import SoftParams
from tracer_torch.kernels import _lib

PARAMS = SoftParams()
SP = 64
IMG_ATOL, LOSS_RTOL, GRAD_RTOL = 2e-6, 1e-6, 1e-5


def _scene(c, r, a):
    return tt.Scene(centers=torch.as_tensor(np.asarray(c, np.float32)),
                    radii=torch.as_tensor(np.asarray(r, np.float32)),
                    albedo=torch.as_tensor(np.asarray(a, np.float32)))


def _unit(d):
    d = np.asarray(d, np.float64)
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _random(n, world, seed, rays=1024):
    rng = np.random.default_rng(seed)
    scene = _scene(rng.uniform(-world / 2, world / 2, (n, 3)),
                   np.full(n, 0.5), rng.uniform(0, 1, (n, 3)))
    return scene, np.zeros((rays, 3), np.float32), \
        _unit(rng.uniform(-1, 1, (rays, 3)))


def _one_leaf():
    """20 spheres, one leaf: every subpacket lists at most 1 leaf."""
    scene, o, d = _random(20, 8.0, 11, rays=512)
    return scene, o + np.float32(9.0), d


def _parked():
    """37 spheres at leaf 32: a leaf of 5 real slots and 27 parked ones;
    subpackets of 1 and 2 leaves share a block."""
    return _random(37, 12.0, 12, rays=512)


def _behind():
    """Rays from the cube's middle: half of each ray's spheres lie behind
    its origin (the second sigmoid's clip reached)."""
    return _random(600, 40.0, 13)


def _through_centre():
    """Rays along the axes through spheres on them: the perpendicular
    vector is exactly 0 (perp2's maximum at its tie)."""
    rng = np.random.default_rng(14)
    axes = np.eye(3)
    c = np.concatenate([axes * k for k in (4.0, 7.0, -5.0)]
                       + [rng.uniform(-10, 10, (40, 3))])
    n = len(c)
    d = np.concatenate([np.repeat(axes, 100, 0), -np.repeat(axes, 100, 0),
                        _unit(rng.uniform(-1, 1, (424, 3)))])
    return (_scene(c, rng.uniform(0.3, 0.8, n), rng.uniform(0, 1, (n, 3))),
            np.zeros((len(d), 3), np.float32), _unit(d))


def _clip_bounds():
    """Rays straight up into an empty sky (blue exactly 1.0, on the
    clip's bound) beside rays into spheres, half of them bright (albedo
    0.95: channels clipped at 1), half dim."""
    rng = np.random.default_rng(15)
    c = rng.uniform(-6, 6, (60, 3)) + [0.0, -20.0, 0.0]
    a = np.where(rng.uniform(0, 1, (60, 1)) < 0.5, 0.95,
                 rng.uniform(0, 0.5, (60, 3)))
    d = np.concatenate([np.tile([[0.0, 1.0, 0.0]], (256, 1)),
                        rng.uniform(-1, 1, (256, 3)) * [0.3, 0.0, 0.3]
                        + [0.0, -1.0, 0.0]])
    return (_scene(c, np.full(60, 1.5), a), np.zeros((512, 3), np.float32),
            _unit(d))


def _equal_t():
    """Spheres twice, at one centre and radius but of other albedo: every
    ray meets each pair at equal t, composited in candidate order as the
    stable sort keeps it."""
    rng = np.random.default_rng(16)
    c = rng.uniform(-8, 8, (50, 3))
    return (_scene(np.concatenate([c, c]), np.full(100, 0.9),
                   rng.uniform(0, 1, (100, 3))),
            np.zeros((512, 3), np.float32),
            _unit(rng.uniform(-1, 1, (512, 3))))


CASES = {"one_leaf": _one_leaf, "many_leaves": lambda: _random(1200, 60.0, 17),
         "parked": _parked, "behind": _behind,
         "through_centre": _through_centre, "clip_bounds": _clip_bounds,
         "equal_t": _equal_t}


def _block(scene, o, d, seed):
    """The evaluation's single block: prep, phase A at budgets that cover
    the table, the subpackets sorted by width, and each padded slot's
    caller ray; a target drawn from ``seed``."""
    n = o.shape[0]
    scale = sparse.soft_radius_scale(PARAMS, widths=30.0)
    tables = tt.build_cull_tables(scene, tt.build_bvh(
        scene.centers, scene.radii * scale, leaf_size=32, device="cpu"))
    rays = tt.Ray(origin=torch.as_tensor(o), direction=torch.as_tensor(d))
    padded, dest = tt.prep_rays_bucketed(rays, SP, 4)
    (ids, valid, n_eff, over), _ = sparse._soft_phase_a(
        padded.origin, padded.direction, tables, SP)(
            tables.num_groups, tables.leaves_per_chunk)
    assert not over
    P = ids.shape[0]
    order = sorted(range(P), key=n_eff.__getitem__)
    perm = torch.as_tensor(order)
    owner = torch.full((P * SP,), n, dtype=torch.long)
    owner[dest] = torch.arange(n)
    owner = owner.reshape(P, SP)[perm].reshape(-1)
    po = padded.origin.reshape(P, SP, 3)[perm].reshape(-1, 3)
    pd = padded.direction.reshape(P, SP, 3)[perm].reshape(-1, 3)
    width = max(max(n_eff), 1)
    target = torch.as_tensor(np.random.default_rng(seed).uniform(
        0, 1, (n, 3)).astype(np.float32))
    return (tables, po, pd, ids[perm][:, :width], valid[perm][:, :width],
            [n_eff[i] for i in order], owner, target, n)


def _autograd(scene, tables, po, pd, ids, valid, owner, target, n):
    """Loss, image rows and gradients by autograd over ``_soft_block``."""
    leaves = [x.clone().requires_grad_(True)
              for x in (scene.centers, scene.radii, scene.albedo)]
    img, _ = sparse._soft_block(*leaves, po, pd, ids, valid, tables, PARAMS,
                                SP)
    keep = (owner < n)[:, None]
    if target is None:
        term = torch.where(keep, img, torch.zeros_like(img))
    else:
        diff = img - target[torch.clamp(owner, max=n - 1)]
        term = torch.where(keep, diff * diff, torch.zeros_like(diff))
    loss = torch.sum(term) / (3 * n)
    loss.backward()
    return loss.detach(), img.detach(), [x.grad for x in leaves]


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


@pytest.mark.parametrize("with_target", [True, False],
                         ids=["target", "mean"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_autograd(case, with_target):
    scene, o, d = CASES[case]()
    tables, po, pd, ids, valid, widths, owner, target, n = _block(
        scene, o, d, 20)
    target = target if with_target else None
    r_loss, r_img, r_grads = _autograd(scene, tables, po, pd, ids, valid,
                                       owner, target, n)
    img, term, real, state = sparse.soft_composite_plain(
        scene, po, pd, ids, valid, widths, owner, target, n, tables, PARAMS,
        SP)
    grads = tuple(torch.zeros_like(x)
                  for x in (scene.centers, scene.radii, scene.albedo))
    sparse.soft_backward_plain(state, grads, PARAMS)
    keep = owner < n
    assert float((img - r_img)[keep].abs().max()) <= IMG_ATOL
    loss = term / (3 * n)
    assert abs(float(loss) - float(r_loss)) <= LOSS_RTOL * float(r_loss)
    for g, r in zip(grads, r_grads):
        assert float(torch.linalg.vector_norm(r)) > 0
        assert _rel(g, r) <= GRAD_RTOL
    assert int(real.sum()) == int(
        sum((tables.slot_to_sphere[(ids[p, :w].long()[:, None] * 32
                                    + torch.arange(32)).reshape(-1)] >= 0)
            .sum() for p, w in enumerate(widths)))


def test_widths_cover_one_and_many_leaves():
    """The cases reach subpackets of one listed leaf and of many, and
    blocks that mix widths (the padding columns of narrow subpackets)."""
    one = _block(*_one_leaf(), 0)[5]
    many = _block(*_random(1200, 60.0, 17), 0)[5]
    parked = _block(*_parked(), 0)[5]
    assert max(one) == 1
    assert max(many) >= 8 and min(many) < max(many)
    assert set(parked) >= {1, 2}


def test_clip_bounds_case_sits_on_the_bounds():
    """The sky rays' blue channel composites to exactly 1.0, and bright
    spheres push a channel past 1: both sides of the clip are exercised."""
    scene, o, d = _clip_bounds()
    tables, po, pd, ids, valid, widths, owner, target, n = _block(
        scene, o, d, 0)
    img, _, _, state = sparse.soft_composite_plain(
        scene, po, pd, ids, valid, widths, owner, target, n, tables, PARAMS,
        SP)
    up = pd[:, 1] == 1.0
    assert bool((img[up & (owner < n), 2] == 1.0).all())
    g = state[4]
    assert bool((g[2].reshape(-1)[up & (owner < n)] != 0).any())


def test_cpu_tensors_take_the_plain_version():
    """A CPU evaluation runs the torch operations: no kernel launch."""
    scene, o, d = _random(300, 30.0, 18, rays=256)
    tables = _block(scene, o, d, 0)[0]
    _lib.launches.pop("soft_cuda", None)
    sparse.soft_loss_grad_sparse(
        scene, tt.Ray(origin=torch.as_tensor(o), direction=torch.as_tensor(d)),
        None, tables, PARAMS, cell_bits=4)
    assert _lib.launches["soft_cuda"] == 0


@pytest.mark.parametrize("fault", ["dtype", "contiguous", "device"])
def test_the_wrapper_raises_on_what_the_kernels_do_not_take(fault):
    """``soft_composite_cuda`` checks dtype, layout and device before any
    launch: a float64 image target, a non-contiguous direction, CPU
    tensors."""
    scene, o, d = _random(300, 30.0, 18, rays=256)
    tables, po, pd, ids, valid, widths, owner, target, n = _block(
        scene, o, d, 0)
    if fault == "dtype":
        target = target.double()
    elif fault == "contiguous":
        pd = torch.cat([pd, pd], dim=1)[:, ::2]
    match = {"dtype": "float32", "contiguous": "contiguous",
             "device": "CUDA"}[fault]
    with pytest.raises(ValueError, match=match):
        sparse.soft_composite_cuda(scene, po, pd, ids, valid, widths, owner,
                                   target, n, tables, PARAMS, SP)
    assert _lib.launches["soft_cuda"] == 0


def test_layouts_follow_the_observed_widths():
    """Runs of subpackets share a layout chosen from their capacity alone:
    a warp a ray up to 2,048 keys, the CTA a ray above, keys in device
    memory past 16,384."""
    caps = [32, 64, 512, 1024, 1056, 2048, 4096, 16384, 16416]
    assert sparse.soft_layouts(caps) == [
        (0, 2, 32, 8, 256, True), (2, 3, 32, 8, 512, True),
        (3, 4, 32, 8, 1024, True), (4, 6, 32, 4, 2048, True),
        (6, 7, 256, 1, 4096, True), (7, 8, 256, 1, 16384, True),
        (8, 9, 256, 1, 32768, False)]
