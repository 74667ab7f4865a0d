"""PyTorch port vs the JAX package: the scaling harness, the sharded
training step and the sharded, microbatched fit on eight gloo ranks on the
CPU, and a fit killed mid-run and resumed.

The counterparts of ``tests/test_scaling_train.py``, on its seeds and
shapes; the JAX side runs on the virtual 8-device CPU mesh, the port's
ranks are spawned once for the module (``tests/torch_dist_ranks.py``).

The port's sharded gradient is the gradient of the mean loss over all
rays, read off its Adam state after one step (the first moment is 0.1 g):
the step's on the (2, 4), (4, 2), (8, 1) and (1, 8) meshes equals the
port's unsharded gradient and JAX's unsharded ``jax.grad`` (run in float64:
the port's perp2 does not cancel, JAX's f32 one does) to 1e-5 of the
largest value, and the sharded fit's losses equal the unsharded fit's. The
JAX package's sharded gradients are R * S times that (R ray, S scene
shards; ROADMAP.md section 3), and stay here as the fault's witness: its
step's moments on (2, 4) are 8 times its own unsharded gradient, and its
fit's on 8 ray shards 8 times its unsharded fit's (to 1e-4 of the largest:
JAX's two programs are compiled apart and fuse differently).

Bounds: the step's loss to 1e-5 relative; the sharded fit's losses over 5
steps, T = 1 and T = 4, to 1e-5 relative of the unsharded fit's; a step
whose k_top is below the shard size keeps its loss within 3 times the
mean dropped sigma of the unsharded loss (``tracer_torch/dist/train.py``).
"""

import json
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_dist_ranks as ranks
from tests import torch_parity as tp
from tests.torch_parity import one_thread  # noqa: F401
from tracer.config import TracerConfig as JConfig
from tracer.diff.fit import fit_scene as j_fit_scene
from tracer.diff.soft import SoftParams as JSoftParams
from tracer.diff.soft import soft_render as j_soft_render
from tracer.dist.mesh import RAY_AXIS, SCENE_AXIS, ray_mesh as j_ray_mesh
from tracer.scene.camera import Camera as JCamera
from tracer.scene.camera import camera_rays as j_camera_rays
from tracer.scene.scene import benchmark_scene

WORLD = 8
FIT_STEPS = 5
LOSS_RTOL = 1e-5
FIT_LOSS_RTOL = 1e-5      # the sharded fit's losses against the unsharded
GRAD_RTOL = 1e-5          # sharded against unsharded gradients, of the largest
JAX_SCALE_RTOL = 1e-4     # JAX's R * S witness, its two compiled programs
MESHES = [(2, 4), (4, 2), (8, 1), (1, 8)]
JAX_MESH = (2, 4)
TOPK = ((2, 4), 1)        # a mesh whose shards hold 8 spheres, and k_top
CAM_STEPS, CAM_LR = 20, 3e-3
SCENARIOS = ["scaling", "train_direct", "train_loss", "train_topk", "fit",
             "camera_fit"]


def _scene_np(scene):
    return tuple(tp.np_(x) for x in (scene.centers, scene.radii,
                                     scene.albedo))


def _camera_rays_np(w, h):
    rays = j_camera_rays(JCamera.default(), JConfig(width=w, height=h,
                                                    max_depth=1))
    return (tp.np_(rays.origin).reshape(-1, 3),
            tp.np_(rays.direction).reshape(-1, 3))


CAM_W, CAM_H = 40, 32


def _port_soft_image(scene_np, w, h):
    """The port's soft image of a numpy scene at the default pose."""
    from tracer_torch.config import TracerConfig
    from tracer_torch.diff.soft import soft_render
    from tracer_torch.interop import scene_from_numpy
    from tracer_torch.scene.camera import Camera
    with torch.no_grad():
        return tp.np_(soft_render(scene_from_numpy(*scene_np, device="cpu"),
                                  Camera.default("cpu"), None,
                                  TracerConfig(width=w, height=h,
                                               max_depth=1)))


def _off_pose():
    """(yaw, position) of the camera fit's start: the default pose off by
    0.02 rad in yaw and 0.1 in x."""
    cam = JCamera.default()
    return (np.float32(tp.np_(cam.yaw) + 0.02),
            tp.np_(cam.position) + np.float32([0.1, 0.0, 0.0]))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every scenario's inputs, and every rank's results."""
    tmp = tmp_path_factory.mktemp("scaling_train")
    rng = np.random.default_rng(0)
    d = rng.uniform(-1, 1, size=(1024, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, dd = _camera_rays_np(16, 8)
    fit_cfg = JConfig(width=16, height=16, max_depth=1)
    target = j_soft_render(benchmark_scene(jax.random.PRNGKey(4), 24,
                                           world_size=40.0),
                           JCamera.default(), None, fit_cfg)
    cam_scene = _scene_np(benchmark_scene(jax.random.PRNGKey(5), 12,
                                          world_size=40.0, radius=3.0))
    cam_target = _port_soft_image(cam_scene, CAM_W, CAM_H)
    train_scene = _scene_np(benchmark_scene(
        jax.random.PRNGKey(3), 32, world_size=40.0, radius=4.0))
    inputs = {
        "scaling_scene": _scene_np(benchmark_scene(jax.random.PRNGKey(0), 64,
                                                   world_size=40.0)),
        "scaling_rays": (np.zeros_like(d), d),
        "train_direct": (*_scene_np(benchmark_scene(
            jax.random.PRNGKey(0), 16, world_size=40.0, radius=4.0)),
            o, dd, (4, 2), None),
        "train_loss": (*train_scene, o, dd, MESHES, None),
        "train_topk": (*train_scene, o, dd, *TOPK),
        "fit": (*_scene_np(benchmark_scene(jax.random.PRNGKey(3), 24,
                                           world_size=40.0)),
                tp.np_(target), (16, 16), FIT_STEPS),
        "camera_fit": (*cam_scene, cam_target,
                       (CAM_W, CAM_H), CAM_STEPS,
                       _off_pose(), CAM_LR),
        "fit_checkpoints": str(tmp),
    }
    out = ranks.run(WORLD, SCENARIOS, inputs, tmp)
    return inputs, out


def _leaves(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k != "__meta__"}


def _assert_close(got, want, rtol, name):
    """got equal to want within rtol of want's largest magnitude."""
    assert np.abs(want).max() > 0, name
    np.testing.assert_allclose(got, want, atol=rtol * np.abs(want).max(),
                               rtol=0, err_msg=name)


def test_scaling_harness_runs_on_gloo_ranks(world):
    _, out = world
    rows = out[0]["scaling"]
    assert [r["devices"] for r in rows] == [1, 2, 8]
    assert all(np.isfinite(r["mrays_per_s"]) and r["mrays_per_s"] > 0
               and r["ms"] > 0 and r["ms_quarter_batch"] > 0
               and r["work_ms"] >= 0 and r["overhead_ms"] >= 0
               for r in rows)
    assert rows[0]["efficiency"] == 1.0
    assert set(rows[0]) == {"devices", "ms", "ms_quarter_batch", "work_ms",
                            "overhead_ms", "mrays_per_s", "efficiency"}
    # Rank 0's rows reach every rank. No performance claim on gloo ranks.
    assert all(res["scaling"] == rows for res in out)


def test_train_step_direct(world):
    _, out = world
    got = out[0]["train_direct"]
    assert np.isfinite(got["l1"]) and np.isfinite(got["l2"])
    assert got["l2"] <= got["l1"] + 1e-6
    assert not np.allclose(got["p0"], got["p2"])
    assert got["count"] == 2
    for res in out[1:]:
        np.testing.assert_array_equal(res["train_direct"]["p2"], got["p2"])
        assert res["train_direct"]["l2"] == got["l2"]


@pytest.fixture(scope="module")
def jax_step(world):
    """The JAX step on the (2, 4) mesh: (loss, mu) after one step, JAX's
    unsharded gradient of the soft_render loss compiled in f32 (the
    witness's), and the same gradient in float64."""
    return _jax_train_step(world[0])


def _jax_train_step(inputs):
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from tracer.core.types import Ray as JRay
    from tracer.diff.fit import params_to_scene
    from tracer.dist.train import make_train_step
    from tracer.scene.scene import fixed_scene
    c, r, a, o, d, _, _ = inputs["train_loss"]
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(JAX_MESH),
                (RAY_AXIS, SCENE_AXIS))
    init_fn, factory = make_train_step(mesh, soft=JSoftParams(),
                                       k_top=len(c) // JAX_MESH[1])
    params, state = init_fn(fixed_scene(c, r, a))
    step = factory(state)

    def shard(x, spec):
        return jax.device_put(x, NamedSharding(mesh, spec))
    params = jax.tree_util.tree_map(lambda x: shard(x, P(SCENE_AXIS)),
                                    params)
    state = jax.tree_util.tree_map(
        lambda x: shard(x, P(SCENE_AXIS) if getattr(x, "ndim", 0) > 0
                        else P()), state)
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    _, state, loss = step(params, state, *(shard(x, P(RAY_AXIS)) for x in
                                           (jo, jd, jnp.zeros_like(jo))))

    def mean_loss(p, o, d):
        img = j_soft_render(params_to_scene(p), None, JSoftParams(),
                            rays=JRay(origin=o, direction=d))
        return jnp.mean(img ** 2)
    p0 = init_fn(fixed_scene(c, r, a))[0]
    grad = jax.jit(jax.grad(mean_loss))(p0, jo, jd)
    with tp.x64():
        grad64 = jax.grad(mean_loss)({k: tp.f64(v) for k, v in p0.items()},
                                     tp.f64(o), tp.f64(d))
    return (float(loss), {k: tp.np_(v) for k, v in state[0].mu.items()},
            {k: tp.np_(v) for k, v in grad.items()},
            {k: tp.np_(v) for k, v in grad64.items()})


def test_sharded_train_loss_equals_unsharded_soft_render(world, jax_step):
    _, out = world
    got = out[0]["train_loss"]
    for shape in MESHES:
        np.testing.assert_allclose(got[shape]["loss"], got["ref_loss"],
                                   rtol=LOSS_RTOL, err_msg=str(shape))
        assert all(res["train_loss"][shape]["loss"] == got[shape]["loss"]
                   for res in out)
    np.testing.assert_allclose(got[JAX_MESH]["loss"], jax_step[0],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_train_gradient_is_the_loss_gradient(world, jax_step,
                                                     shape):
    """One step's first moment is 0.1 g, and g is the gradient of the mean
    loss over all rays: the port's unsharded gradient and JAX's unsharded
    ``jax.grad`` in float64, to GRAD_RTOL of the largest value, on every
    mesh; every rank returns the same moments."""
    _, out = world
    got = out[0]["train_loss"]
    grad64 = jax_step[3]
    mu = got[shape]["mu"]
    for k in sorted(mu):
        _assert_close(mu[k] / 0.1, got["ref_grad"][k], GRAD_RTOL, k)
        _assert_close(mu[k] / 0.1, grad64[k], GRAD_RTOL, k)
        assert all(np.array_equal(res["train_loss"][shape]["mu"][k], mu[k])
                   for res in out)


def test_jax_sharded_train_gradient_is_r_s_times_the_loss_gradient(
        jax_step):
    """The reference's fault, kept as its witness: JAX's step on (2, 4)
    gives 8 = 2 x 4 times its unsharded gradient of the mean loss."""
    _, jmu, jgrad, _ = jax_step
    R, S = JAX_MESH
    for k in sorted(jmu):
        _assert_close(jmu[k] / 0.1, R * S * jgrad[k], JAX_SCALE_RTOL, k)


def test_sharded_train_loss_with_a_small_k_top_is_within_the_dropped_tail(
        world):
    """k_top 1 below the shard size of 8 drops candidates: the loss moves
    off the unsharded one, by at most 3 times the mean over rays of the
    dropped sigmas' sum (the bound ``tracer_torch/dist/train.py`` states;
    measured 1.7e-3 against 3 x 8.4e-3); every rank returns the same
    loss."""
    _, out = world
    got = out[0]["train_topk"]
    diff = abs(got["loss"] - got["ref_loss"])
    assert got["dropped"] > 0 and diff > 0
    assert diff <= 3.0 * got["dropped"], (diff, got["dropped"])
    assert all(res["train_topk"]["loss"] == got["loss"] for res in out)


def test_fit_microbatched_overlap_matches_single(world):
    _, out = world
    for res in out:
        r1, r4 = res["fit"]["t1"], res["fit"]["t4"]
        np.testing.assert_allclose(r1["losses"], r4["losses"], rtol=1e-5)
        np.testing.assert_allclose(r1["centers"], r4["centers"], atol=1e-5)
        np.testing.assert_array_equal(r1["centers"],
                                      out[0]["fit"]["t1"]["centers"])


def test_fit_sharded_is_the_unsharded_fit(world, tmp_path):
    """The fit on 8 ray shards: after one step its first moments
    (checkpoint leaves 7-9, one layout in both packages) equal the
    unsharded fit's, and its losses over FIT_STEPS steps, T = 1 and T = 4,
    equal the unsharded fit's (FIT_LOSS_RTOL). JAX's
    ``fit_scene(mesh=ray_mesh(8))`` moments are 8 times its unsharded
    fit's, the reference's fault."""
    from tracer.scene.scene import fixed_scene
    from tracer_torch.config import TracerConfig
    from tracer_torch.diff.fit import fit_scene
    from tracer_torch.interop import scene_from_numpy
    from tracer_torch.scene.camera import Camera
    inputs, out = world
    c, r, a, target, (w, h), steps = inputs["fit"]
    jcfg = JConfig(width=w, height=h, max_depth=1)

    def jax_fit(n, **kw):
        return j_fit_scene(jnp.asarray(target), fixed_scene(c, r, a),
                           JCamera.default(), steps=n, config=jcfg, **kw)
    paths = {k: str(tmp_path / f"{k}.npz") for k in ("jax8", "jax", "port")}
    jax_fit(1, mesh=j_ray_mesh(8), checkpoint_path=paths["jax8"])
    jax_fit(1, checkpoint_path=paths["jax"])
    fit_scene(torch.as_tensor(target), scene_from_numpy(c, r, a,
                                                         device="cpu"),
              Camera.default("cpu"), steps=1,
              config=TracerConfig(width=w, height=h, max_depth=1),
              checkpoint_path=paths["port"])
    sharded = {"jax": _leaves(paths["jax8"]),
               "port": _leaves(os.path.join(inputs["fit_checkpoints"],
                                            "step1.npz"))}
    scale = {"jax": WORLD, "port": 1}
    for side in ("jax", "port"):
        plain = _leaves(paths[side])
        assert sorted(plain) == sorted(sharded[side])
        for i in range(7, 10):
            k = f"leaf_{i}"
            _assert_close(sharded[side][k], scale[side] * plain[k],
                          GRAD_RTOL if side == "port" else JAX_SCALE_RTOL,
                          f"{side} {k}")
    want = out[0]["fit"]["plain"]["losses"]
    assert len(want) == FIT_STEPS
    for t in (1, 4):
        np.testing.assert_allclose(out[0]["fit"][f"t{t}"]["losses"], want,
                                   rtol=FIT_LOSS_RTOL, err_msg=f"T = {t}")


def test_camera_fit_on_eight_ranks_shrinks_the_pose_error(world):
    """fit_scene(optimize_camera=True) on 8 ray shards, T = 1 and T = 4,
    from the pose off by 0.02 rad in yaw and 0.1 in x: the pose's view
    error (``fit.view_error``) falls to under half, as on one rank, and
    the losses equal the unsharded camera fit's to FIT_LOSS_RTOL of the
    first loss (near its minimum the loss is ~1e-2 of the first, where the
    two sums' rounding is a larger share of it)."""
    from tracer_torch.diff.fit import view_error
    from tracer_torch.scene.camera import Camera
    inputs, out = world
    c = inputs["camera_fit"][0]
    true = Camera.default("cpu")
    depth = float(np.linalg.norm(c - tp.np_(true.position), axis=1).mean())
    yaw, position = _off_pose()
    start = true.replace(yaw=torch.tensor(yaw),
                         position=torch.as_tensor(position))
    plain = out[0]["camera_fit"]["plain"]
    for t in (1, 4):
        got = out[0]["camera_fit"][f"t{t}"]
        end = true.replace(**{k: torch.as_tensor(got[k]) for k in (
            "position", "yaw", "pitch")})
        before, after = (view_error(x, true, depth) for x in (start, end))
        assert after < before / 2, (t, before, after)
        np.testing.assert_allclose(
            got["losses"], plain["losses"], rtol=0, err_msg=f"T = {t}",
            atol=FIT_LOSS_RTOL * plain["losses"][0])
        assert all(np.array_equal(res["camera_fit"][f"t{t}"]["yaw"],
                                  got["yaw"]) for res in out)


def test_fit_on_a_one_rank_mesh_equals_the_unsharded_fit(world):
    _, out = world
    got = out[0]["fit"]
    for k in ("losses", "centers", "radii", "albedo"):
        np.testing.assert_array_equal(got["one"][k], got["plain"][k])
    assert all("one" not in res["fit"] for res in out[1:])


_CHILD = r"""
import sys
import torch
torch.set_num_threads(1)
from tracer_torch.config import TracerConfig
from tracer_torch.diff.fit import fit_scene
from tracer_torch.diff.soft import soft_render
from tracer_torch.scene.camera import Camera
from tracer_torch.scene.scene import benchmark_scene

cfg = TracerConfig(width=48, height=48, max_depth=1)
cam = Camera.default("cpu")
scene = benchmark_scene(torch.Generator().manual_seed(3), 12,
                        world_size=40.0, device="cpu")
target = soft_render(benchmark_scene(torch.Generator().manual_seed(4), 12,
                                     world_size=40.0, device="cpu"),
                     cam, None, cfg).detach()
print("START", any(m == "jax" or m.startswith("jax.") for m in sys.modules),
      flush=True)
fit_scene(target, scene, cam, steps=100000, lr=1e-2, config=cfg,
          checkpoint_path=sys.argv[1], checkpoint_every=1)
"""


def _ckpt_step(path):
    try:
        with np.load(path) as z:
            return int(json.loads(bytes(z["__meta__"]))["step"])
    except Exception:
        return -1


def test_fault_injection_kill_and_resume(tmp_path):
    """A process fitting with the port (no JAX) is SIGKILLed after its
    third checkpoint or later, resumed from its last checkpoint, and the
    continuation is bitwise the uninterrupted run."""
    from tracer_torch.config import TracerConfig
    from tracer_torch.diff.fit import fit_scene
    from tracer_torch.diff.soft import soft_render
    from tracer_torch.scene.camera import Camera
    from tracer_torch.scene.scene import benchmark_scene as t_scene
    ckpt = str(tmp_path / "fit.npz")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-c", _CHILD, ckpt], env=env,
                            cwd=repo, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    try:
        assert proc.stdout.readline().split() == ["START", "False"]
        deadline = time.time() + 300
        while time.time() < deadline and _ckpt_step(ckpt) < 3:
            time.sleep(0.05)
            if proc.poll() is not None:
                raise AssertionError("child exited before its checkpoints")
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait()
    s = _ckpt_step(ckpt)
    assert s >= 3, f"no usable checkpoint before the kill (step {s})"

    cfg = TracerConfig(width=48, height=48, max_depth=1)
    cam = Camera.default("cpu")
    scene = t_scene(torch.Generator().manual_seed(3), 12, world_size=40.0,
                    device="cpu")
    target = soft_render(t_scene(torch.Generator().manual_seed(4), 12,
                                 world_size=40.0, device="cpu"),
                         cam, None, cfg).detach()
    total = s + 5
    resumed = fit_scene(target, scene, cam, steps=total, lr=1e-2,
                        config=cfg, checkpoint_path=ckpt, resume=True)
    clean = fit_scene(target, scene, cam, steps=total, lr=1e-2, config=cfg)
    assert len(resumed.step_ms) == total - s
    for k in ("centers", "radii", "albedo"):
        np.testing.assert_array_equal(tp.np_(getattr(resumed.scene, k)),
                                      tp.np_(getattr(clean.scene, k)))
    np.testing.assert_array_equal(resumed.losses, clean.losses)
