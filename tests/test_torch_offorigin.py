"""The port's closest-hit and shadow queries on rays that start far from
the world's origin, held against the plain reference
(``benchmark/reference/sphere.py``, the reference's acceptance rule in f32
over every sphere).

The walks test each (ray, sphere) pair on oc = o - c with the reference's
sums (``leafcull.ray_prim_u``), so they take its decisions wherever the ray
starts. The JAX package expands |o|^2 - 2 o.c + (|c|^2 - r^2) instead: off
the origin those terms are of size |c|^2 and, in f32, lose a discriminant
of size r^2, so it misses grazing hits that the reference takes (and takes
some it misses). The rays here are camera-like points at |o| ~ 50 aimed
at spheres, points on spheres at |c| ~ 500 aimed at their neighbours, and,
as a regression case, the grazing primary rays of a camera at (0, 4, 50)
over spheres at |c| ~ 500 on which renders at 100,000 spheres once missed
hits.
"""

import numpy as np
import pytest
import torch

import tracer_torch as tt
from benchmark.reference.sphere import closest_hit
from tests.torch_parity import one_thread  # noqa: F401
from tracer_torch.intersect.brute import brute_t_fast
from tracer_torch.kernels.leafcull import (nearest_hit_leafcull_checked,
                                           occluded_leafcull_checked)
from tracer_torch.scene.scene import fixed_scene

WORLD = 1000.0
R = 0.5


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _aim(rng, o, c, spread):
    """Unit directions from o through c moved off its centre by up to
    ``spread`` radii across the ray: hits, grazes and near misses."""
    d = _unit(c - o)
    side = _unit(np.cross(d, rng.normal(size=d.shape)))
    off = spread * R * np.sqrt(rng.uniform(0.0, 1.0, (len(d), 1)))
    return _unit(c + off * side - o)


def _world(n=3000, seed=7):
    """n spheres of r = 0.5 uniform in [-500, 500]^3; sphere 5 is stored
    again as sphere 11 (an exact tie, which the walk breaks to its lowest
    slot)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-WORLD / 2, WORLD / 2, (n, 3)).astype(np.float32)
    c[11] = c[5]
    r = np.full(n, R, np.float32)
    return c, r


def _rays(c, seed=8, b=512):
    """(o, d) float32: ``b`` camera-like rays from |o| ~ 50 aimed at
    spheres, then ``b`` rays from points on spheres at |c| ~ 500 aimed at
    a near neighbour; a tenth of the first aim at the stored-twice
    sphere."""
    rng = np.random.default_rng(seed)
    o1 = 50.0 * _unit(rng.normal(size=(b, 3))) + rng.uniform(-2, 2, (b, 3))
    t1 = c[rng.integers(0, len(c), b)]
    t1[::10] = c[5]
    d1 = _aim(rng, o1, t1, 1.3)
    far = np.nonzero(np.abs(np.linalg.norm(c, axis=1) - 500.0) < 60.0)[0]
    src = far[rng.integers(0, len(far), b)]
    dist = np.linalg.norm(c[src, None] - c[None], axis=-1)
    dist[np.arange(b), src] = np.inf
    near = np.argsort(dist, axis=1)[:, :4]
    tgt = c[near[np.arange(b), rng.integers(0, 4, b)]]
    o2 = c[src] + R * _unit(tgt - c[src] + rng.normal(0, 0.3, (b, 3)))
    d2 = _aim(rng, o2, tgt, 1.3)
    o = np.concatenate([o1, o2]).astype(np.float32)
    d = np.concatenate([d1, d2]).astype(np.float32)
    return torch.as_tensor(o), torch.as_tensor(d)


def _tie_winner(tables, ids, a, b):
    """Where the reference answers sphere a or b (stored twice), the
    sphere of the lower of their slots: the walk's answer."""
    sts = tables.cull.slot_to_sphere
    first = int(torch.nonzero((sts == a) | (sts == b))[0])
    ids = ids.clone()
    ids[(ids == a) | (ids == b)] = int(sts[first])
    return ids


@pytest.fixture(scope="module")
def world():
    c, r = _world()
    scene = fixed_scene(c, r, device="cpu")
    tables = tt.build_cone_tables(scene, tt.build_bvh(c, r, leaf_size=8,
                                                      device="cpu"))
    o, d = _rays(c)
    t_ref, id_ref = closest_hit(o, d, scene.centers, scene.radii)
    return dict(scene=scene, tables=tables, o=o, d=d, t_ref=t_ref,
                id_ref=_tie_winner(tables, id_ref, 5, 11), raw_id=id_ref)


def test_rays_reach_far_and_graze(world):
    """The rays are what the tests claim: origins off the world's origin,
    both kinds hitting, the tie taken, and misses among them."""
    o, hit = world["o"], world["id_ref"] >= 0
    assert (o.norm(dim=1)[:512] > 40).all()
    assert (o.norm(dim=1)[512:] > 400).all()
    assert 100 < int(hit[:512].sum()) < 512
    assert 100 < int(hit[512:].sum()) < 512
    assert int(((world["raw_id"] == 5) | (world["raw_id"] == 11)).sum()) > 20


def test_nearest_hit_leafcull_matches_reference_off_origin(world):
    rays = tt.Ray(world["o"], world["d"])
    rec, _ = nearest_hit_leafcull_checked(rays, world["scene"],
                                          world["tables"], 8, 16,
                                          cell_bits=0)
    assert torch.equal(rec.index.long(), world["id_ref"])
    assert torch.equal(rec.t, world["t_ref"])


def test_occluded_leafcull_matches_reference_off_origin(world):
    """Shadow rays with unnormalised directions (a = |d|^2 != 1): t_max
    half or one and a half times the reference's nearest t (t_max = 2e3
    where it misses), so each ray's answer is set by its nearest sphere."""
    o, d, t_ref = world["o"], world["d"], world["t_ref"]
    scale = torch.linspace(0.5, 3.0, o.shape[0])[:, None]
    factor = torch.where(torch.arange(o.shape[0]) % 2 == 0, 0.5, 1.5)
    t_max = torch.where(torch.isfinite(t_ref), t_ref * factor,
                        torch.full_like(t_ref, 2e3)) / scale[:, 0]
    occ, _ = occluded_leafcull_checked(tt.Ray(o, d * scale),
                                       world["tables"], t_max, 8, 16,
                                       cell_bits=0)
    t_s, _ = closest_hit(o, d * scale, world["scene"].centers,
                         world["scene"].radii)
    want = t_s < t_max
    assert want.any() and not want.all()
    assert torch.equal(occ, want)


def test_brute_t_fast_matches_reference_off_origin(world):
    t, idx = brute_t_fast(world["o"], world["d"], world["scene"].centers,
                          world["scene"].radii, block=300)
    assert torch.equal(idx.long(), world["raw_id"])
    assert torch.equal(t, world["t_ref"])


# ---------------------------------------------------------------------------
# the regression: a camera at (0, 4, 50), spheres at |c| ~ 500, grazing rays
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def grazing():
    """400 spheres at |c| in [480, 520] in front of a camera at (0, 4, 50)
    (the benchmark's first pose), and 4,096 primary rays aimed at them
    through the outer half of their radius: the rays on which an expanded
    quadratic misses hits."""
    rng = np.random.default_rng(17)
    n = 400
    v = _unit(rng.normal(size=(n, 3)))
    v[:, 2] = -np.abs(v[:, 2]) - 0.5
    c = (_unit(v) * rng.uniform(480, 520, (n, 1))).astype(np.float32)
    r = np.full(n, R, np.float32)
    b = 4096
    o = np.tile(np.float32([0.0, 4.0, 50.0]), (b, 1))
    tgt = c[rng.integers(0, n, b)]
    d = _unit(tgt - o)
    side = _unit(np.cross(d, rng.normal(size=d.shape)))
    off = R * rng.uniform(0.5, 1.0, (b, 1))
    d = _unit(tgt + off * side - o).astype(np.float32)
    scene = fixed_scene(c, r, device="cpu")
    tables = tt.build_cone_tables(scene, tt.build_bvh(c, r, leaf_size=8,
                                                      device="cpu"))
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    t_ref, id_ref = closest_hit(o, d, scene.centers, scene.radii)
    return dict(scene=scene, tables=tables, o=o, d=d, t_ref=t_ref,
                id_ref=id_ref)


def test_grazing_primary_hits_are_not_missed(grazing):
    g = grazing
    assert 500 < int((g["id_ref"] >= 0).sum()) < 4000
    rec, _ = nearest_hit_leafcull_checked(tt.Ray(g["o"], g["d"]), g["scene"],
                                          g["tables"], 8, 16, cell_bits=0)
    assert torch.equal(rec.index.long(), g["id_ref"])
    assert torch.equal(rec.t, g["t_ref"])


def test_grazing_primary_hits_dense_path(grazing):
    g = grazing
    t, idx = brute_t_fast(g["o"], g["d"], g["scene"].centers,
                          g["scene"].radii, block=1024)
    assert torch.equal(idx.long(), g["id_ref"])
    assert torch.equal(t, g["t_ref"])
