"""PyTorch port vs the JAX package: the debug tools and the render flags.

``bvh_stats`` must give the JAX dict on the same JAX-built tree;
``project_points`` the JAX projection within 1e-4 px, and points along a
pixel's ray (the port's ray generation) must project back onto that pixel;
``draw_bvh_wireframe`` the JAX overlay on the same image, tree and camera.
On the command line: ``viz`` prints the statistics and writes its PNG;
``render --checkpoint/--resume`` resumed at frame 2 of 4 equals a straight
run bit for bit, also on a fly-through (where the JAX command restarts the
camera); ``render --profile`` writes a trace naming the frames' operations.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest

import tracer_torch as tt
from tests import torch_parity as tp
from tests.torch_parity import one_thread  # noqa: F401
from tracer.bvh.flat import bvh_stats as j_bvh_stats
from tracer.config import TracerConfig as JConfig
from tracer.scene.camera import Camera as JCamera
from tracer.viz.wireframe import draw_bvh_wireframe as j_draw
from tracer.viz.wireframe import project_points as j_project
from tracer_torch import cli
from tracer_torch.bvh.flat import bvh_stats
from tracer_torch.config import TracerConfig
from tracer_torch.interop import camera_from_numpy
from tracer_torch.viz.wireframe import draw_bvh_wireframe, project_points

POSES = [((0.0, 4.0, 50.0), -np.pi, 0.0, 45.0),
         ((3.0, -2.0, 20.0), -2.6, 0.3, 60.0)]


def _cameras(pose):
    pos, yaw, pitch, fov = pose
    jcam = JCamera(position=jnp.asarray(pos, jnp.float32),
                   yaw=jnp.float32(yaw), pitch=jnp.float32(pitch),
                   fov=jnp.float32(fov))
    return jcam, camera_from_numpy(pos, yaw, pitch, fov, device="cpu")


@pytest.mark.parametrize("n,leaf", [(1, 4), (33, 4), (500, 8), (3000, 32)])
def test_bvh_stats_match_jax(n, leaf):
    c, r, _ = tp.scene_np(n, seed=n, world=80.0)
    jb, tb = tp.bvhs(c, r, leaf)
    got, want = bvh_stats(tb, n), j_bvh_stats(jb, n)
    assert got == want


@pytest.mark.parametrize("pose", POSES)
@pytest.mark.parametrize("compat", [True, False])
def test_project_points_match_jax(pose, compat):
    cfg = TracerConfig(width=64, height=48, double_aspect_compat=compat)
    jcfg = JConfig(width=64, height=48, double_aspect_compat=compat)
    jcam, cam = _cameras(pose)
    pts = np.random.default_rng(2).uniform(-60, 60, (500, 3)) \
        .astype(np.float32)
    x, y, ok = project_points(pts, cam, cfg)
    jx, jy, jok = j_project(pts, jcam, jcfg)
    np.testing.assert_array_equal(ok, jok)
    assert ok.sum() > 100
    np.testing.assert_allclose(x[ok], jx[ok], atol=1e-4, rtol=0)
    np.testing.assert_allclose(y[ok], jy[ok], atol=1e-4, rtol=0)


def test_projection_inverts_the_ports_raygen():
    """tests/test_tools.py:41-52 on the port's camera_rays."""
    cfg = TracerConfig(width=64, height=48)
    cam = tt.Camera.default("cpu")
    rays = tt.camera_rays(cam, cfg)
    for (py, px) in [(5, 7), (24, 32), (40, 60)]:
        p = (rays.origin[py, px] + 12.3 * rays.direction[py, px]).numpy()
        x, y, ok = project_points(p[None], cam, cfg)
        assert ok[0]
        assert abs(x[0] - px) < 0.75 and abs(y[0] - py) < 0.75, (x, y)


@pytest.mark.parametrize("pose", POSES)
def test_wireframe_matches_jax(pose):
    c, r, _ = tp.scene_np(40, seed=4, world=40.0)
    jb, tb = tp.bvhs(c, r, 4)
    jcam, cam = _cameras(pose)
    img = np.random.default_rng(3).uniform(0, 1, (48, 64, 3)) \
        .astype(np.float32)
    got = draw_bvh_wireframe(img, tb, cam, TracerConfig(width=64, height=48),
                             max_draw_depth=5)
    want = j_draw(img, jb, jcam, JConfig(width=64, height=48),
                  max_draw_depth=5)
    assert (got != img).any()
    np.testing.assert_array_equal(got, np.asarray(want))


def test_cli_viz_prints_stats_and_writes_png(tmp_path, capsys):
    out = tmp_path / "v.png"
    assert cli.main(["viz", "--device", "cpu", "--width", "32", "--height",
                     "24", "--spheres", "6", "--viz-depth", "3", "--out",
                     str(out)]) == 0
    text = capsys.readouterr().out
    stats = json.loads(text[:text.index("}") + 1])
    assert stats["num_leaves"] >= 2 and stats["mean_leaf_occupancy"] > 0
    assert out.read_bytes().startswith(b"\x89PNG\r\n\x1a\n")


RENDER = ["render", "--device", "cpu", "--width", "32", "--height", "24",
          "--depth", "3", "--spheres", "300", "--scene", "benchmark",
          "--world-size", "60", "--compact", "--impl", "leafcull"]


@pytest.mark.parametrize("fly", ["0", "1"])
def test_cli_render_resume_equals_a_straight_run(tmp_path, fly):
    """4 frames straight against 2 frames, a checkpoint, and a resume to
    4: the accumulated images equal bit for bit. On a fly-through every
    frame moves the camera, so the image is the last frame's and holds the
    camera's place at frame 3."""
    args = RENDER + ["--fly-speed", fly]
    cli.main(args + ["--frames", "4", "--checkpoint",
                     str(tmp_path / "s.npz"), "--out",
                     str(tmp_path / "s.png")])
    cli.main(args + ["--frames", "2", "--checkpoint",
                     str(tmp_path / "c.npz"), "--out",
                     str(tmp_path / "c.png")])
    cli.main(args + ["--frames", "4", "--checkpoint",
                     str(tmp_path / "c.npz"), "--resume", "--out",
                     str(tmp_path / "c.png")])
    straight, resumed = (np.load(tmp_path / f"{k}.npy") for k in "sc")
    np.testing.assert_array_equal(resumed, straight)
    two = tmp_path / "two"
    cli.main(args + ["--frames", "2", "--out", str(two) + ".png"])
    assert not np.array_equal(np.load(str(two) + ".npy"), straight)


def test_cli_render_profile_writes_a_trace(tmp_path):
    cli.main(RENDER + ["--frames", "2", "--profile", str(tmp_path / "p"),
                       "--out", str(tmp_path / "p.png")])
    trace = json.loads((tmp_path / "p" / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
