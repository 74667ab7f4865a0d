"""PyTorch port vs the JAX package: camera, sampling, shading and frames.

``camera_rays``, ``hemisphere_from_noise``, ``sky_color`` and the
compaction permutation are held against the JAX functions on the same
inputs. Whole 32x24 frames (depth 3, 256 spheres, path and direct modes,
with and without compaction) go through every port intersector the
renderer offers and are held against JAX ``render`` / ``render_direct``
with ``nearest_hit_brute`` on the same numpy bounce noise: primary sphere
ids equal except at a graze or a tie, images within 1e-5 on >= 99.5 % of
pixels. The leaf-walk HitRecord and shadow queries escalate their budgets
and agree with the dense oracles; the command line writes its image and
metrics.
"""

import argparse
import json
import os
import struct
import subprocess
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tracer_torch as tt
from tests import torch_parity as tp
from tests.torch_parity import one_thread  # noqa: F401
from tracer.config import TracerConfig as JConfig
from tracer.core import sampling as jsampling
from tracer.core.sort import sort_rays_by_direction as j_sort_rays
from tracer.core.types import Ray as JRay
from tracer.integrator import wavefront as jwf
from tracer.intersect.brute import any_hit_brute as j_any_hit_brute
from tracer.intersect.brute import nearest_hit_brute as j_nearest_brute
from tracer.scene.camera import Camera as JCamera
from tracer.scene.camera import camera_rays as j_camera_rays
from tracer_torch import cli
from tracer_torch.config import TracerConfig
from tracer_torch.core import sampling
from tracer_torch.core.sort import sort_rays_by_direction
from tracer_torch.integrator import wavefront as wf
from tracer_torch.interop import camera_from_numpy
from tracer_torch.kernels.conecull import build_cone_tables
from tracer_torch.kernels.leafcull import (nearest_hit_leafcull_checked,
                                           occluded_leafcull,
                                           occluded_leafcull_checked)
from tracer_torch.scene.camera import camera_rays

W, H, DEPTH = 32, 24, 3
LIGHT = (0.0, 200.0, 0.0)
IMPLS = ["brute", "dense", "traverse", "pallas", "tilecull", "leafcull"]


def _interactive_scene(n, seed):
    """The interactive distribution (src/sphere.c:52-59) as numpy."""
    rng = np.random.default_rng(seed)
    c = rng.uniform([-40, -20, -10], [40, 20, 5], (n, 3)).astype(np.float32)
    r = rng.uniform(0.5, 5.0, n).astype(np.float32)
    a = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return c, r, a


def _cams(position=(0.0, 4.0, 50.0), yaw=-np.pi, pitch=0.0, fov=45.0):
    j = JCamera(position=jnp.asarray(position, jnp.float32),
                yaw=jnp.float32(yaw), pitch=jnp.float32(pitch),
                fov=jnp.float32(fov))
    return j, camera_from_numpy(position, yaw, pitch, fov, device="cpu")


# ---------------------------------------------------------------------------
# camera, sampling, sky, compaction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pose,compat", [
    (((0.0, 4.0, 50.0), -np.pi, 0.0, 45.0), True),
    (((3.0, -2.0, 10.0), 0.7, -0.3, 60.0), False),
])
def test_camera_rays_match_jax(pose, compat):
    jcam, cam = _cams(*pose)
    r = camera_rays(cam, TracerConfig(width=W, height=H,
                                      double_aspect_compat=compat))
    jr = j_camera_rays(jcam, JConfig(width=W, height=H,
                                     double_aspect_compat=compat))
    assert tuple(r.direction.shape) == (H, W, 3)
    np.testing.assert_allclose(tp.np_(r.direction), tp.np_(jr.direction),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tp.np_(r.origin), tp.np_(jr.origin))
    for x, y in zip(cam.basis(), jcam.basis()):
        np.testing.assert_allclose(tp.np_(x), tp.np_(y), atol=1e-6)


def test_camera_default_matches_jax():
    cam, jcam = tt.scene.camera.Camera.default("cpu"), JCamera.default()
    for f in ("position", "yaw", "pitch", "fov"):
        np.testing.assert_array_equal(tp.np_(getattr(cam, f)),
                                      tp.np_(getattr(jcam, f)))


def test_hemisphere_from_noise_matches_jax():
    rng = np.random.default_rng(3)
    noise = rng.normal(size=(200, 3)).astype(np.float32)
    normal = rng.normal(size=(200, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    noise[0] = 0.0                                   # zero-draw guard
    normal[1] = [0.0, 0.0, 1.0]
    noise[1] = [1.0, 2.0, 0.0]                       # dot == 0: negated
    got = tp.np_(sampling.hemisphere_from_noise(torch.as_tensor(noise),
                                                torch.as_tensor(normal)))
    want = tp.np_(jsampling.hemisphere_from_noise(jnp.asarray(noise),
                                                  jnp.asarray(normal)))
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)
    np.testing.assert_array_equal(got[0], [1.0, 0.0, 0.0]
                                  if normal[0] @ [1, 0, 0] > 0
                                  else [-1.0, 0.0, 0.0])
    assert got[1, 0] < 0 and got[1, 1] < 0           # the negated edge case
    assert ((got * normal).sum(-1)[2:] > 0).all()
    gen = torch.Generator().manual_seed(0)
    s = sampling.uniform_on_hemisphere(gen, torch.as_tensor(normal))
    assert ((tp.np_(s) * normal).sum(-1) >= 0).all()
    np.testing.assert_allclose(np.linalg.norm(tp.np_(s), axis=-1), 1.0,
                               rtol=1e-6)


def test_sky_color_matches_jax():
    d = np.random.default_rng(4).uniform(-1, 1, (64, 3)).astype(np.float32)
    np.testing.assert_allclose(tp.np_(wf.sky_color(torch.as_tensor(d))),
                               tp.np_(jwf.sky_color(jnp.asarray(d))),
                               atol=1e-7, rtol=0)


def test_compact_rays_and_direction_sort_match_jax():
    rng = np.random.default_rng(5)
    o = rng.normal(size=(H, W, 3)).astype(np.float32)
    d = rng.normal(size=(H, W, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[0, :8] = d[0, 0]                               # equal codes: stability
    active = rng.random((H, W)) < 0.6
    r, inv = wf._compact_rays(tt.Ray(torch.as_tensor(o), torch.as_tensor(d)),
                              torch.as_tensor(active))
    jr, jinv = jwf._compact_rays(JRay(jnp.asarray(o), jnp.asarray(d)),
                                 jnp.asarray(active))
    np.testing.assert_array_equal(tp.np_(inv), tp.np_(jinv))
    np.testing.assert_array_equal(tp.np_(r.origin), tp.np_(jr.origin))
    np.testing.assert_array_equal(tp.np_(r.direction), tp.np_(jr.direction))
    s, sinv = sort_rays_by_direction(tt.Ray(torch.as_tensor(o),
                                            torch.as_tensor(d)))
    js, jsinv = j_sort_rays(JRay(jnp.asarray(o), jnp.asarray(d)))
    np.testing.assert_array_equal(tp.np_(sinv), tp.np_(jsinv))
    np.testing.assert_array_equal(tp.np_(s.direction), tp.np_(js.direction))


def test_bounce_noise_and_accumulator():
    gen = torch.Generator().manual_seed(1)
    n = wf.bounce_noise(gen, (H, W), DEPTH)
    assert tuple(n.shape) == (DEPTH - 1, H, W, 3)
    assert tuple(wf.bounce_noise(gen, (H, W), 1).shape) == (0, H, W, 3)
    acc = wf.Accumulator.zero(H, W)
    img = torch.rand(H, W, 3)
    acc = acc.reset_to(img).add(img * 0.5)
    assert acc.frames == 2
    torch.testing.assert_close(acc.mean, img * 0.75)


# ---------------------------------------------------------------------------
# frames through every intersector
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def frame_setup():
    c, r, a = _interactive_scene(256, seed=8)
    jscene, tscene = tp.scenes(c, r, a)
    noise = np.random.default_rng(9).normal(
        size=(DEPTH - 1, H, W, 3)).astype(np.float32)
    jcam, cam = _cams()
    return dict(jscene=jscene, tscene=tscene, noise=noise, jcam=jcam,
                cam=cam, jframes={})


def _recording(nearest_for, out):
    """Wrap nearest_hit_for so the first call's sphere ids land in out."""
    def wrapped(s):
        f = nearest_for(s)

        def g(r):
            rec = f(r)
            out.append(tp.np_(rec.index).reshape(-1))
            return rec
        return g
    return wrapped


def _jax_frame(setup, mode, compact):
    key = (mode, compact)
    if key not in setup["jframes"]:
        ids = []
        cfg = JConfig(width=W, height=H, max_depth=DEPTH)
        nearest = _recording(lambda s: (lambda r: j_nearest_brute(r, s)),
                             ids)
        if mode == "path":
            img = jwf.render(setup["jscene"], setup["jcam"], None, nearest,
                             cfg, noise=jnp.asarray(setup["noise"]),
                             compact=compact)
        else:
            img = jwf.render_direct(
                setup["jscene"], setup["jcam"], jnp.asarray(LIGHT), nearest,
                lambda s: (lambda r, tm: j_any_hit_brute(r, s, tm)), cfg,
                compact=compact)
        setup["jframes"][key] = (tp.np_(img), ids[0])
    return setup["jframes"][key]


def _args(impl, mode="path", compact=False):
    return argparse.Namespace(impl=impl, bvh=True, leaf_size=16,
                              max_candidates=128, mode=mode, compact=compact,
                              light=",".join(map(str, LIGHT)),
                              light_intensity=1.0)


def _explained(o, d, centers, radii, ia, ib):
    """Rays whose choices ia/ib differ only by a graze (|disc| within 1e-5
    of b'^2 for a chosen sphere) or a tie (equal t to 1e-5)."""
    o, d = o.astype(np.float64), d.astype(np.float64)
    ts, graze = [], np.zeros(len(ia), bool)
    for idx in (ia, ib):
        c = centers[np.maximum(idx, 0)].astype(np.float64)
        rr = radii[np.maximum(idx, 0)].astype(np.float64)
        oc = o - c
        a = (d * d).sum(1)
        bp = (oc * d).sum(1)
        disc = bp * bp - a * ((oc * oc).sum(1) - rr * rr)
        graze |= (idx >= 0) & (np.abs(disc) <= 1e-5 * bp * bp)
        ts.append(np.where(idx >= 0, (-bp - np.sqrt(np.maximum(disc, 0)))
                           / a, np.inf))
    tie = (ia >= 0) & (ib >= 0) & (np.abs(ts[0] - ts[1])
                                   <= 1e-5 * np.abs(ts[1]))
    return graze | tie


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("mode", ["path", "direct"])
@pytest.mark.parametrize("impl", IMPLS)
def test_frame_matches_jax_brute(frame_setup, impl, mode, compact):
    jimg, jids = _jax_frame(frame_setup, mode, compact)
    scene, cam = frame_setup["tscene"], frame_setup["cam"]
    args = _args(impl, mode, compact)
    counts = {}
    nearest, info = cli.make_nearest(args, scene, cam, torch.device("cpu"),
                                     counts)
    assert info["impl"] == impl
    ids = []
    nearest = _recording(nearest, ids)
    cfg = TracerConfig(width=W, height=H, max_depth=DEPTH)
    if mode == "path":
        img = wf.render(scene, cam, None, nearest, cfg,
                        noise=torch.as_tensor(frame_setup["noise"]),
                        compact=compact)
        assert len(ids) == DEPTH
    else:
        occluded = cli.make_occluded(args, scene, torch.device("cpu"),
                                     counts)
        img = wf.render_direct(scene, cam, LIGHT, nearest, occluded, cfg,
                               compact=compact)
    r = camera_rays(cam, cfg)
    o, d = tp.np_(r.origin).reshape(-1, 3), tp.np_(r.direction).reshape(-1, 3)
    bad = ids[0] != jids
    assert (ids[0] >= 0).sum() > 100          # the frame hits spheres
    assert bad.mean() <= 0.01
    assert _explained(o[bad], d[bad], tp.np_(scene.centers),
                      tp.np_(scene.radii), ids[0][bad], jids[bad]).all()
    close = (np.abs(tp.np_(img) - jimg) <= 1e-5).all(-1)
    assert close.mean() >= 0.995, close.mean()
    if impl in ("tilecull", "leafcull"):
        assert counts["closest_calls"] == (DEPTH if mode == "path" else 1)


def test_leafcull_queries_escalate_and_match_oracles():
    """The leaf-walk HitRecord and shadow queries at a budget of one leaf,
    on wide subpackets (no direction cells) over a 2-prim-leaf tree,
    overflow, escalate and then equal their full-budget results and the
    dense oracles (shadow rays: unnormalised directions, t_max = 1)."""
    c, r, a = tp.scene_np(6000, seed=13, world=80.0)
    _, scene = tp.scenes(c, r, a)
    tables = build_cone_tables(scene, tt.build_bvh(c, r, leaf_size=2,
                                                   device="cpu"))
    o, d = tp.origin_rays_np(900, seed=14)
    rays = tt.Ray(torch.as_tensor(o), torch.as_tensor(d))
    rec, esc = nearest_hit_leafcull_checked(rays, scene, tables, 8, 1,
                                            cell_bits=0)
    assert esc >= 1
    full, esc0 = nearest_hit_leafcull_checked(rays, scene, tables)
    assert esc0 == 0
    assert torch.equal(rec.index, full.index)
    ref = tt.nearest_hit_brute(rays, scene)
    assert int(full.hit.sum()) > 30
    assert torch.equal(full.index, ref.index)
    torch.testing.assert_close(full.t, ref.t)

    hit_pt = rays.origin + 30.0 * rays.direction
    srays = tt.Ray(hit_pt, torch.tensor([0.0, 200.0, 0.0]) - hit_pt)
    occ, esc = occluded_leafcull_checked(srays, tables, 1.0, 8, 1,
                                         cell_bits=0)
    assert esc >= 1
    occ_full, ovf = occluded_leafcull(srays, tables, torch.ones(900))
    assert not bool(ovf)
    assert torch.equal(occ, occ_full)
    assert 0 < int(occ.sum()) < 900
    tp.assert_occ_matches(occ, tt.any_hit_brute(srays, scene, 1.0),
                          srays.origin, srays.direction, scene.centers,
                          scene.radii, np.ones(900, np.float32))


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def _read_png(path):
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, size = 8, b"", None
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        if kind == b"IHDR":
            size = struct.unpack(">II", body[:8])
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h = size
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 3 * w + 1)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, 3)


def test_cli_render_writes_image_and_metrics(tmp_path):
    out = tmp_path / "frame.png"
    metrics = tmp_path / "m.json"
    proc = subprocess.run(
        [sys.executable, "-m", "tracer_torch.cli", "render", "--device",
         "cpu", "--width", str(W), "--height", str(H), "--depth", "2",
         "--frames", "2", "--out", str(out), "--metrics", str(metrics)],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr
    img = np.load(tmp_path / "frame.npy")
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    np.testing.assert_array_equal(_read_png(out),
                                  (img * 255).astype(np.uint8))
    m = json.loads(metrics.read_text())
    for k in ("width", "height", "max_depth", "spheres", "frames", "compact",
              "mean_frame_s", "fps", "mrays_per_s", "platform", "impl",
              "bvh_build_ms"):
        assert k in m, k
    assert (m["impl"], m["platform"], m["spheres"]) == ("dense", "cpu", 20)


def test_cli_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main(["render", "--width", "8", "--height", "6"])
