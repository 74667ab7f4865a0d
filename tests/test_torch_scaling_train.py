"""PyTorch port vs the JAX package: the scaling harness, the sharded
training step and the sharded, microbatched fit on eight gloo ranks on the
CPU, and a fit killed mid-run and resumed.

The counterparts of ``tests/test_scaling_train.py``, on its seeds and
shapes; the JAX side runs on the virtual 8-device CPU mesh, the port's
ranks are spawned once for the module (``tests/torch_dist_ranks.py``).

The gradient of the sharded step and of the sharded fit is the reference's:
read off JAX's Adam state after one step (optax's first moment is 0.1 g),
the JAX step's gradient is 8 times the gradient of the mean loss on a
(2, 4) mesh (ray shards x scene shards), and the JAX fit's on 8 ray shards
is 8 times the unsharded fit's.

How tightly the port can be held to JAX here is set by the soft model's
perp2 = |oc|^2 - t_ca^2 |d|^2, which cancels in f32 for these small, far
spheres (ROADMAP.md section 3): compiled whole, XLA contracts mul+add where
torch rounds each op, and an ulp there moves a silhouette pixel's sigma by
~1e-3. Running the JAX side op by op (``jax.disable_jit``) removes that,
but takes about a minute per call on the virtual mesh, so the JAX side
runs compiled, with these bounds:

  * each side's sharded gradient is 8 times its own unsharded one: the
    port's to 1e-5 of the largest value (measured 4e-8), JAX's to 1e-4
    (compiled apart, the two programs fuse differently);
  * the step's loss to 1e-5 relative, and its moments to 5e-4 of the
    largest (measured: 2.0e-4, one centre component);
  * the fit's losses over three steps to 2e-3 relative (measured 1.5e-3).
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
FIT_STEPS = 3
LOSS_RTOL = 1e-5
FIT_LOSS_RTOL = 2e-3      # three fit steps, against the compiled JAX fit
SCALE_RTOL = 1e-5         # sharded against 8 x unsharded, of the largest
JAX_SCALE_RTOL = 1e-4     # the same for JAX's two compiled programs
JAX_GRAD_RTOL = 5e-4      # the step's moments against JAX's, of the largest
SCENARIOS = ["scaling", "train_direct", "train_loss", "fit"]


def _scene_np(scene):
    return tuple(tp.np_(x) for x in (scene.centers, scene.radii,
                                     scene.albedo))


def _camera_rays_np(w, h):
    rays = j_camera_rays(JCamera.default(), JConfig(width=w, height=h,
                                                    max_depth=1))
    return (tp.np_(rays.origin).reshape(-1, 3),
            tp.np_(rays.direction).reshape(-1, 3))


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
    inputs = {
        "scaling_scene": _scene_np(benchmark_scene(jax.random.PRNGKey(0), 64,
                                                   world_size=40.0)),
        "scaling_rays": (np.zeros_like(d), d),
        "train_direct": (*_scene_np(benchmark_scene(
            jax.random.PRNGKey(0), 16, world_size=40.0, radius=4.0)),
            o, dd, (4, 2), None),
        "train_loss": (*_scene_np(benchmark_scene(
            jax.random.PRNGKey(3), 32, world_size=40.0, radius=4.0)),
            o, dd, (2, 4), 8),
        "fit": (*_scene_np(benchmark_scene(jax.random.PRNGKey(3), 24,
                                           world_size=40.0)),
                tp.np_(target), (16, 16), FIT_STEPS),
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
    """The JAX step on the (2, 4) mesh: (loss, mu, nu) after one step, and
    JAX's unsharded gradient of the soft_render loss."""
    return _jax_train_step(world[0])


def _jax_train_step(inputs):
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from tracer.dist.train import make_train_step
    from tracer.scene.scene import fixed_scene
    c, r, a, o, d, shape, k_top = inputs["train_loss"]
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(shape),
                (RAY_AXIS, SCENE_AXIS))
    init_fn, factory = make_train_step(mesh, soft=JSoftParams(), k_top=k_top)
    params, state = init_fn(fixed_scene(c, r, a))
    step = factory(state)

    def shard(x, spec):
        return jax.device_put(x, NamedSharding(mesh, spec))
    params = jax.tree_util.tree_map(lambda x: shard(x, P(SCENE_AXIS)),
                                    params)
    state = jax.tree_util.tree_map(
        lambda x: shard(x, P(SCENE_AXIS) if getattr(x, "ndim", 0) > 0
                        else P()), state)
    o, d = jnp.asarray(o), jnp.asarray(d)
    _, state, loss = step(params, state, *(shard(x, P(RAY_AXIS)) for x in
                                           (o, d, jnp.zeros_like(o))))

    from tracer.core.types import Ray as JRay
    from tracer.diff.fit import params_to_scene

    def mean_loss(p):
        img = j_soft_render(params_to_scene(p), None, JSoftParams(),
                            rays=JRay(origin=o, direction=d))
        return jnp.mean(img ** 2)
    grad = jax.jit(jax.grad(mean_loss))(init_fn(fixed_scene(c, r, a))[0])
    return (float(loss), {k: tp.np_(v) for k, v in state[0].mu.items()},
            {k: tp.np_(v) for k, v in grad.items()})


def test_sharded_train_loss_equals_unsharded_soft_render(world, jax_step):
    _, out = world
    got = out[0]["train_loss"]
    np.testing.assert_allclose(got["loss"], got["ref_loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["loss"], jax_step[0], rtol=LOSS_RTOL)
    assert all(res["train_loss"]["loss"] == got["loss"] for res in out)


def test_sharded_train_gradient_is_the_references(world, jax_step):
    """One step's first moment is 0.1 g. JAX's g is 8 = 2 x 4 times its
    unsharded gradient of the mean loss; the port's is 8 times its own, and
    equal to JAX's."""
    _, out = world
    got = out[0]["train_loss"]
    _, jmu, jgrad = jax_step
    for k in sorted(got["mu"]):
        _assert_close(jmu[k] / 0.1, WORLD * jgrad[k], JAX_SCALE_RTOL, k)
        _assert_close(got["mu"][k] / 0.1, WORLD * got["ref_grad"][k],
                      SCALE_RTOL, k)
        _assert_close(got["mu"][k], jmu[k], JAX_GRAD_RTOL, k)


def test_fit_microbatched_overlap_matches_single(world):
    _, out = world
    for res in out:
        r1, r4 = res["fit"]["t1"], res["fit"]["t4"]
        np.testing.assert_allclose(r1["losses"], r4["losses"], rtol=1e-5)
        np.testing.assert_allclose(r1["centers"], r4["centers"], atol=1e-5)
        np.testing.assert_array_equal(r1["centers"],
                                      out[0]["fit"]["t1"]["centers"])


def test_fit_sharded_matches_jax(world, tmp_path):
    """The fit on 8 ray shards against JAX ``fit_scene(mesh=ray_mesh(8))``:
    after one step each side's first moments (checkpoint leaves 7-12, one
    layout in both packages) are 8 times its unsharded fit's; the losses of
    T = 1 and T = 4 over three steps equal JAX's."""
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
    for side in ("jax", "port"):
        plain = _leaves(paths[side])
        assert sorted(plain) == sorted(sharded[side])
        for i in range(7, 10):
            k = f"leaf_{i}"
            _assert_close(sharded[side][k], WORLD * plain[k],
                          SCALE_RTOL if side == "port" else JAX_SCALE_RTOL,
                          f"{side} {k}")
    want = jax_fit(steps, mesh=j_ray_mesh(8))
    for t in (1, 4):
        np.testing.assert_allclose(out[0]["fit"][f"t{t}"]["losses"],
                                   want.losses, rtol=FIT_LOSS_RTOL)


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
