"""Direct-lit frames of the port against the plain reference on the CPU.

The port's whole direct frame (``render --mode direct``: one closest hit
for the camera rays, one shadow query from each hit point toward the
point light, Lambertian shading) is built by ``cli.prepare`` as the
renderer builds it and held against ``benchmark/reference/direct.py``
(brute force over every sphere in float32, no tree), with wavefront
compaction on and off: under ``--impl leafcull`` (the plain leaf walk and
the plain any-hit walk behind their escalating drivers), under ``--impl
auto`` (the dense sweep and the dense shadow oracle at this size), and
with the shadow query's budgets cut to one group so that it escalates.
The scene is dense enough, and the light placed so, that lit, shadowed
and sky pixels all occur. Shadow rays from points on spheres far off the
origin (|c| ~ 500, unnormalised directions of length ~400) are held
against the reference's any-hit.

Tolerance: a channel may differ from the reference's by 1e-5 at most.
The port and the reference take the same sphere for every pixel here and
compute its point, normal and light vector by the same float32 formulas;
what is left is the rounding of |light - p| and of n.l (a few ulps of
values at most 1). The reference computed in bfloat16 is off by ~1e-3 on
nearly every pixel (its sky alone, from d.y in 8 bits), and fails it.
"""

import numpy as np
import pytest
import torch

import tracer_torch as tt
from benchmark.reference import direct as ref
from benchmark.reference.path import camera_rays as ref_camera_rays
from benchmark.reference.sphere import closest_hit
from tests.torch_parity import one_thread  # noqa: F401
from tracer_torch import cli, trace
from tracer_torch.integrator import wavefront as wf
from tracer_torch.kernels import leafcull
from tracer_torch.scene.scene import fixed_scene

W, H = 64, 48
LIGHT = (0.0, 200.0, 0.0)
# 1,000 spheres of r = 0.5 in a cube of side 40 before the default camera
# at (0, 4, 50): about a third of the camera rays hit, and a fifth of the
# shadow rays toward the light above cross another sphere.
FRAME = ["render", "--mode", "direct", "--device", "cpu", "--width",
         str(W), "--height", str(H), "--spheres", "1000", "--scene",
         "benchmark", "--world-size", "40", "--seed", "3", "--light",
         ",".join(map(str, LIGHT))]
TOL = 1e-5


def _session(impl, compact):
    argv = FRAME + ["--impl", impl,
                    "--compact" if compact else "--no-compact"]
    return cli.prepare(cli.build_parser().parse_args(argv))


def _reference(session, dtype=torch.float32):
    """The reference's (H*W, 3) image of the session's frame, and each
    pixel's class: 0 sky, 1 lit, 2 shadowed (a hit facing the light whose
    shadow ray is blocked), 3 a hit facing away."""
    cam, scene = session.camera, session.scene
    px = torch.arange(W * H)
    o, d = ref_camera_rays(cam.position, float(cam.yaw), float(cam.pitch),
                           float(cam.fov), W, H, px, dtype)
    img = ref.shade(o, d, scene.centers, scene.radii, scene.albedo, LIGHT,
                    1.0, 0.1, dtype=dtype)
    t, idx = closest_hit(o, d, scene.centers, scene.radii)
    hit = idx >= 0
    p = o[hit] + t[hit, None] * d[hit]
    to_light = torch.tensor(LIGHT) - p
    facing = ((p - scene.centers[idx[hit]]) * to_light).sum(1) > 0
    blocked = ref.occluded(p, to_light, scene.centers, scene.radii)
    cls = torch.zeros(W * H, dtype=torch.int64)
    cls[hit] = torch.where(facing, torch.where(blocked, 2, 1), 3)
    return img, cls


def _off(img, want):
    """Pixels with a channel off by more than TOL."""
    return ((img.reshape(-1, 3) - want).abs().amax(1) > TOL)


@pytest.fixture(scope="module")
def reference():
    return _reference(_session("auto", False))


def test_the_frame_has_lit_shadowed_and_sky_pixels(reference):
    _, cls = reference
    counts = torch.bincount(cls, minlength=4)
    assert counts[0] > W * H // 4, counts          # sky
    assert counts[1] > 100, counts                 # lit
    assert counts[2] > 20, counts                  # shadowed


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("impl", ["leafcull", "auto"])
def test_direct_frame_matches_the_reference(reference, impl, compact):
    session = _session(impl, compact)
    img = session.frame(session.camera, None)
    assert tuple(img.shape) == (H, W, 3)
    assert int(_off(img, reference[0]).sum()) == 0
    want = {"closest_calls": 1, "closest_escalations": 0,
            "shadow_calls": 1, "shadow_escalations": 0}
    assert session.counts == (want if impl == "leafcull" else {})


@pytest.fixture(scope="module")
def escalating():
    """A frame over 4,000 spheres as dense as FRAME's (a cube of side 64)
    through ``--impl leafcull``, its reference, and the scene's tables in
    two-sphere leaves (148 groups): over these a shadow query from a
    budget of one group and one leaf, on wide subpackets (no direction
    cells), overflows."""
    argv = [a for a in FRAME]
    argv[argv.index("--spheres") + 1] = "4000"
    argv[argv.index("--world-size") + 1] = "64"
    session = cli.prepare(cli.build_parser().parse_args(
        argv + ["--impl", "leafcull"]))
    scene = session.scene
    tables = tt.build_cone_tables(scene, tt.build_bvh(
        scene.centers, scene.radii, leaf_size=2, device="cpu"))
    return session, tables, _reference(session)[0]


@pytest.mark.parametrize("compact", [False, True])
def test_direct_frame_matches_the_reference_when_shadows_escalate(
        escalating, compact):
    """The frame's shadow query from budgets (1, 1) overflows, doubles its
    budgets until nothing overflows, and gives the frame the reference's
    colours."""
    session, tables, want = escalating
    counts = {}
    query = trace.tallied(counts, lambda r, tmax: (
        leafcull.occluded_leafcull_checked(r, tables, tmax, 1, 1,
                                           cell_bits=0)))
    img = wf.render_direct(session.scene, session.camera, LIGHT,
                           session.nearest, lambda s: query, session.config,
                           compact=compact)
    assert counts["shadow_calls"] == 1
    assert counts["shadow_escalations"] >= 2
    assert int(_off(img, want).sum()) == 0


def test_the_bfloat16_reference_fails_the_tolerance(reference):
    session = _session("auto", False)
    img, _ = _reference(session, torch.bfloat16)
    assert _off(img, reference[0]).float().mean() > 0.5


def _spy(monkeypatch, name, calls):
    real = getattr(leafcull, name)

    def spy(*a, **k):
        calls.append(name)
        return real(*a, **k)
    monkeypatch.setattr(leafcull, name, spy)


@pytest.mark.parametrize("impl,walks", [("leafcull", True), ("auto", False),
                                        ("dense", False)])
def test_make_occluded_honours_impl_on_the_cpu(monkeypatch, impl, walks):
    """``--impl leafcull`` takes the checked driver over the any-hit walk's
    plain version on the CPU; ``auto`` and the others keep the dense
    oracle below the card."""
    calls = []
    for name in ("occluded_leafcull_checked", "anyhit_plain"):
        _spy(monkeypatch, name, calls)
    scene = tt.Scene(*(x.to("cpu") for x in (
        torch.rand(300, 3) * 20 - 10, torch.full((300,), 0.5),
        torch.rand(300, 3))))
    args = cli.build_parser().parse_args(FRAME + ["--impl", impl])
    counts = {}
    query = cli.make_occluded(args, scene, torch.device("cpu"), counts)
    o = torch.zeros(64, 3)
    d = torch.randn(64, 3, generator=torch.Generator().manual_seed(1)) * 20
    occ = query(scene)(tt.Ray(o, d), torch.ones(64))
    assert torch.equal(occ, tt.any_hit_brute(tt.Ray(o, d), scene, 1.0))
    assert calls == (["occluded_leafcull_checked", "anyhit_plain"]
                     if walks else [])
    assert counts == ({"shadow_calls": 1, "shadow_escalations": 0}
                      if walks else {})


# ---------------------------------------------------------------------------
# shadow rays far off the origin
# ---------------------------------------------------------------------------

CLUSTER = np.array([300.0, 300.0, 250.0], np.float32)   # |c| ~ 500


@pytest.fixture(scope="module")
def far():
    """2,500 spheres of r = 0.5 in a cube of side 30 around CLUSTER, plus
    2,000 across [-500, 500]^3; the hit points of 1,024 rays from a point
    beside the cluster, as a frame makes them (p = o + t d from the
    reference's closest hit); lights toward the origin (|light - p| ~ 400)
    and inside the cluster, so that segments end before, among and past
    the spheres that block them."""
    rng = np.random.default_rng(24)
    c = np.concatenate([
        CLUSTER + rng.uniform(-15, 15, (2500, 3)),
        rng.uniform(-500, 500, (2000, 3))]).astype(np.float32)
    r = np.full(len(c), 0.5, np.float32)
    scene = fixed_scene(c, r, device="cpu")
    o = torch.as_tensor(np.broadcast_to(CLUSTER + [0, 0, 40],
                                        (1024, 3)).astype(np.float32))
    d = CLUSTER + rng.uniform(-14, 14, (1024, 3)) - o.numpy()
    d = torch.as_tensor((d / np.linalg.norm(d, axis=1, keepdims=True))
                        .astype(np.float32))
    t, idx = closest_hit(o, d, scene.centers, scene.radii)
    hit = idx >= 0
    p = (o + t[:, None] * d)[hit]
    lights = torch.as_tensor(np.where(
        (np.arange(len(p)) % 2 == 0)[:, None], np.array(LIGHT, np.float32),
        CLUSTER + rng.uniform(-15, 15, (len(p), 3))).astype(np.float32))
    return scene, p, lights - p


def test_far_shadow_rays_are_what_the_test_claims(far):
    scene, p, to_light = far
    assert len(p) > 800
    assert (p.norm(dim=1) > 450).all()
    assert (to_light[0::2].norm(dim=1) > 350).all()
    want = ref.occluded(p, to_light, scene.centers, scene.radii)
    for half in (want[0::2], want[1::2]):
        assert 0.1 < float(half.float().mean()) < 0.9


def test_far_shadow_rays_match_the_reference_any_hit(far):
    """Through the renderer's own shadow query (``cli.make_occluded``,
    ``--impl leafcull``: the leaf-32 tree, the checked driver, the plain
    any-hit walk) and through the driver from budgets (32, 32) over tables
    in two-sphere leaves (167 groups), which escalate."""
    scene, p, to_light = far
    want = ref.occluded(p, to_light, scene.centers, scene.radii)
    args = cli.build_parser().parse_args(FRAME + ["--impl", "leafcull"])
    query = cli.make_occluded(args, scene, torch.device("cpu"), {})(scene)
    rays = tt.Ray(p, to_light)
    assert torch.equal(query(rays, torch.ones(len(p))), want)
    tables = tt.build_cone_tables(scene, tt.build_bvh(
        scene.centers, scene.radii, leaf_size=2, device="cpu"))
    occ, esc = leafcull.occluded_leafcull_checked(rays, tables, 1.0, 32,
                                                  32)
    assert esc >= 1
    assert torch.equal(occ, want)
