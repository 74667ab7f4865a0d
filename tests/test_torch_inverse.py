"""The checked soft evaluation (``diff.sparse.soft_loss_grad_sparse``) on
the CPU, against the benchmark's dense plain reference
(``benchmark/reference/soft.py``).

The scene: 1,200 spheres of r = 0.5 in a cube of side 100, albedo in
[0, 1]; 2,048 origin rays of cube-uniform directions; the cull tables from
a tree over radii inflated at widths 30 (the logit clip). The target is
the reference's soft image of the scene moved as ``cli fit`` moves it, so
the loss and every gradient are far from 0.

Bounds, against the reference in float32: image 5e-5 absolute (the two
compute sigma in different float32 sums, the port in its scalar layout,
and the reference leaves out spheres at the clip's floor, at most 1.6e-10
here; measured 1.4e-5); loss 1e-5 relative (measured 1.7e-6); gradients
2e-4 relative L2 (the same rounding through the sigmoids' derivatives;
measured 5.5e-5 at most, the centres'). Between cuts into blocks: 1e-6
absolute in the image and 1e-6 relative L2 in the gradients (the blocks'
sums in another order)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import tracer_torch as tt
from benchmark.reference import soft as ref
from tests.torch_parity import one_thread  # noqa: F401
from tracer_torch import trace
from tracer_torch.diff import sparse
from tracer_torch.diff.soft import SoftParams

N, WORLD, RAYS = 1200, 100.0, 2048
CELL_BITS = 4
PARAMS = SoftParams()
IMG_ATOL, LOSS_RTOL, GRAD_RTOL = 5e-5, 1e-5, 2e-4
BLOCK_ATOL, BLOCK_RTOL = 1e-6, 1e-6
# The image's loss where widths 6 drop a sphere at 1.13 r: sigmoid(-6.5)
# of coverage times (shade - sky), 7.5e-4 measured.
SKIRT_MIN = 2e-4


def _scene(seed: int):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-WORLD / 2, WORLD / 2, (N, 3)).astype(np.float32)
    a = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    return tt.Scene(centers=torch.as_tensor(c), radii=torch.full((N,), 0.5),
                    albedo=torch.as_tensor(a))


def _tables(scene, widths: float):
    scale = sparse.soft_radius_scale(PARAMS, widths=widths)
    return tt.build_cull_tables(scene, tt.build_bvh(
        scene.centers, scene.radii * scale, leaf_size=32, device="cpu"))


def _rays(seed: int):
    d = np.random.default_rng(seed).uniform(-1, 1, (RAYS, 3)) \
        .astype(np.float32)
    d = torch.as_tensor(d / np.linalg.norm(d, axis=1, keepdims=True))
    return tt.Ray(origin=torch.zeros_like(d), direction=d)


@pytest.fixture(scope="module")
def setup():
    """The moved scene, its widths-30 tables, the rays and the target (the
    reference's image of the unmoved scene)."""
    base = _scene(1)
    g = torch.Generator().manual_seed(2)
    scene = tt.Scene(
        centers=base.centers + 0.1 * 0.5 * torch.randn(base.centers.shape,
                                                       generator=g),
        radii=base.radii, albedo=torch.clamp(base.albedo + 0.2, 0.05, 0.95))
    rays = _rays(3)
    target = ref.render(rays.origin, rays.direction, base.centers,
                        base.radii, base.albedo, PARAMS.edge_sharpness,
                        PARAMS.smooth_eps)
    return scene, _tables(scene, 30.0), rays, target


def _evaluate(setup, **kw):
    scene, tables, rays, target = setup
    kw = {"cell_bits": CELL_BITS} | kw
    return sparse.soft_loss_grad_sparse(scene, rays, kw.pop("target", target),
                                        kw.pop("tables", tables), PARAMS,
                                        **kw)


def _reference(setup, target=None):
    scene, _, rays, tgt = setup
    return ref.loss_grad(rays.origin, rays.direction,
                         tgt if target is None else target, scene.centers,
                         scene.radii, scene.albedo, PARAMS.edge_sharpness,
                         PARAMS.smooth_eps)


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


@pytest.fixture(scope="module")
def one_block(setup):
    return _evaluate(setup)


def test_loss_image_and_gradients_match_the_dense_reference(setup,
                                                            one_block):
    loss, img, grads, esc = one_block
    r_loss, r_img, r_grads = _reference(setup)
    assert img.shape == (RAYS, 3)
    assert float((img - r_img).abs().max()) <= IMG_ATOL
    assert abs(float(loss) - float(r_loss)) <= LOSS_RTOL * float(r_loss)
    for g, r in zip(grads, r_grads):
        assert g.shape == r.shape
        assert bool(torch.isfinite(g).all())
        assert float(torch.linalg.vector_norm(r)) > 0
        assert _rel(g, r) <= GRAD_RTOL


def test_the_mean_image_loss_and_its_gradient(setup):
    """Without a target the loss is the image's mean, as ``bench.py``'s
    differentiable metric defines it; its centre gradient against the
    reference's, by autograd through the same dense image."""
    scene, _, rays, _ = setup
    loss, img, grads, _ = _evaluate(setup, target=None)
    c = scene.centers.clone().requires_grad_(True)
    idx = ref.kept(rays.origin, rays.direction, c.detach(), scene.radii,
                   PARAMS.edge_sharpness, PARAMS.smooth_eps)
    r_img = ref.image(rays.origin, rays.direction, c, scene.radii,
                      scene.albedo, idx, PARAMS.edge_sharpness,
                      PARAMS.smooth_eps)
    r_loss = r_img.mean()
    r_loss.backward()
    r_loss = r_loss.detach()
    assert abs(float(loss) - float(r_loss)) <= LOSS_RTOL * float(r_loss)
    assert _rel(grads[0], c.grad) <= GRAD_RTOL


def test_escalating_from_tight_budgets_equals_one_try_at_the_last(setup):
    """From (2, 1) the ladder doubles both budgets; the evaluation is
    bit-equal to one started at the budgets it ended on."""
    scene, tables, _, _ = setup
    loss, img, grads, esc = _evaluate(setup, max_groups=2, max_leaves=1)
    assert esc >= 2
    k0, k = sparse.soft_budgets(tables, esc, 2, 1)
    assert (k0, k) == (min(2 << esc, tables.num_groups),
                       min(1 << esc, tables.leaves_per_chunk))
    loss1, img1, grads1, esc1 = _evaluate(setup, max_groups=k0, max_leaves=k)
    assert esc1 == 0
    assert torch.equal(loss, loss1) and torch.equal(img, img1)
    for g, g1 in zip(grads, grads1):
        assert torch.equal(g, g1)


@pytest.mark.parametrize("blocks", [1, 2, 7])
def test_blocks_agree_with_one_block(setup, one_block, blocks):
    """A byte budget that cuts the evaluation into ``blocks`` blocks (the
    trace's counter) gives the one-block loss, image and gradients to
    float32 rounding."""
    scene, tables, rays, _ = setup
    padded, _ = tt.prep_rays_bucketed(rays, 64, CELL_BITS)
    k0, k = sparse.soft_budgets(tables, one_block[3])
    (_, _, n_eff, _), _ = sparse._soft_phase_a(
        padded.origin, padded.direction, tables, 64)(k0, k)
    widths = sorted(n_eff)
    lane = 64 * tables.leaf_size * sparse.LANE_BYTES
    most = lane * len(widths) * max(widths)
    budget = next(b for b in range(lane, most + lane, lane)
                  if len(sparse._blocks(widths, 64, tables.leaf_size, b))
                  == blocks)
    trace.reset()
    with trace.enabled():
        loss, img, grads, _ = _evaluate(setup, block_bytes=budget)
    (root,) = trace.records()
    assert root["counters"]["blocks"] == blocks
    loss1, img1, grads1, _ = one_block
    assert abs(float(loss) - float(loss1)) <= BLOCK_RTOL * float(loss1)
    assert float((img - img1).abs().max()) <= BLOCK_ATOL
    for g, g1 in zip(grads, grads1):
        assert _rel(g, g1) <= BLOCK_RTOL


def test_an_overflow_at_the_full_table_raises(setup, monkeypatch):
    """Phase A that still truncates at budgets covering the whole table
    (here made to, by a stand-in) raises: no truncated image comes back."""
    real = sparse._leaf_ids

    def truncating(rows, overflow, tables, k):
        ids, valid, _, n_eff = real(rows, overflow, tables, k)
        return ids, valid, torch.ones((), dtype=torch.bool), n_eff
    monkeypatch.setattr(sparse, "_leaf_ids", truncating)
    with pytest.raises(RuntimeError, match="overflow"):
        _evaluate(setup)


def test_widths_30_cover_the_skirt_where_widths_6_drop_a_sphere():
    """Tables over radii inflated at widths 6 (1.12 r) lose a sphere from
    a ray whose sigma there is far above the clip's floor: a lone sphere
    400 units out, in a leaf of its own, and rays from the origin passing
    1.13 r from its centre, outside its widths-6 box and inside its
    widths-30 one (1.6 r). The widths-30 evaluation matches the dense
    reference; the widths-6 one misses the sphere's skirt, sigmoid(-6.5)
    of the silhouette's coverage."""
    rng = np.random.default_rng(5)
    c = np.concatenate([[[0.0, 0.0, 400.0]],
                        rng.uniform(-30, 30, (39, 3)) + [0.0, 0.0, -300.0]])
    a = np.full((40, 3), 0.9)
    scene = tt.Scene(centers=torch.as_tensor(c, dtype=torch.float32),
                     radii=torch.full((40,), 0.5),
                     albedo=torch.as_tensor(a, dtype=torch.float32))
    aim = torch.tensor([1.13 * 0.5, 0.0, 400.0])
    d = (aim / torch.linalg.vector_norm(aim)).expand(64, 3).contiguous()
    rays = tt.Ray(origin=torch.zeros_like(d), direction=d)
    target = torch.zeros_like(d)
    sig, _ = ref.sigma_t(rays.origin[:1, None], d[:1, None],
                         scene.centers[:1][None], scene.radii[:1][None],
                         PARAMS.edge_sharpness, PARAMS.smooth_eps)
    assert float(sig) > 1e9 * ref.floor(torch.float32)
    _, r_img, _ = ref.loss_grad(rays.origin, d, target, scene.centers,
                                scene.radii, scene.albedo,
                                PARAMS.edge_sharpness, PARAMS.smooth_eps)
    err = {}
    for widths in (30.0, 6.0):
        _, img, _, _ = sparse.soft_loss_grad_sparse(
            scene, rays, target, _tables(scene, widths), PARAMS,
            cell_bits=CELL_BITS)
        err[widths] = float((img - r_img).abs().max())
    assert err[30.0] <= IMG_ATOL
    assert err[6.0] > SKIRT_MIN
