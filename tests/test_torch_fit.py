"""PyTorch port vs the JAX package: checkpoints (``tracer_torch.checkpoint``),
the fit (``tracer_torch.diff.fit``) and ``python -m tracer_torch.cli fit``.

The port's checkpoint is the JAX file layout (``leaf_{i}`` in flatten order,
dict keys sorted, ``__meta__`` JSON), so files cross between the packages.
A checkpoint the JAX fit writes is read by ``fit_state_from_jax_checkpoint``
(leaf order taken from the JAX state's own flattening) and continued by the
port: its losses match the JAX run's at rtol 1e-4 (``torch.optim.Adam``
against ``optax.adam``: the same update, rounded in another order; JAX's
f32 perp2 cancels, the port's does not). The port's fit over 6 steps is
held to the JAX fit run in float64 at rtol 1e-5. The camera pose: its
gradient against ``jax.grad`` through JAX's ``soft_render`` with the rays
made from the camera, and a fit with ``optimize_camera=True`` from a
perturbed pose shrinks the pose error. The port's own resume is bitwise,
and the command line writes its four files into the working directory.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tracer_torch as tt
from tests import torch_parity as tp
from tests.torch_parity import one_thread  # noqa: F401
from tracer.checkpoint import load_pytree, save_pytree
from tracer.config import TracerConfig as JConfig
from tracer.diff import fit as jfit
from tracer.diff import soft as jsoft
from tracer.scene.camera import Camera as JCamera
from tracer_torch import cli
from tracer_torch.checkpoint import load_state, save_state
from tracer_torch.config import TracerConfig
from tracer_torch.diff import fit, soft
from tracer_torch.interop import FIT_LEAVES, fit_state_from_jax_checkpoint

W, H = 24, 18
JCFG = JConfig(width=W, height=H, max_depth=2)
CFG = TracerConfig(width=W, height=H, max_depth=2)
LOSS_RTOL = 1e-4      # against the JAX fit in f32 (its checkpoints)
FIT64_RTOL = 1e-5     # against the JAX fit in float64
# The camera fit: a 40x30 frame, the pose off by 0.02 rad in yaw and 0.1 in
# x, 20 steps at lr 3e-3 (3e-2, the scene's rate, overshoots the pose).
CAM_CFG = TracerConfig(width=40, height=30, max_depth=1)
CAM_JCFG = JConfig(width=40, height=30, max_depth=1)
YAW_OFF, POS_OFF = 0.02, (0.1, 0.0, 0.0)
CAM_STEPS, CAM_LR = 20, 3e-3
CAM_GRAD_RTOL = 1e-4  # of max |g_JAX|, against JAX in float64
POSE = ("position", "yaw", "pitch")


def _interactive_np(n, seed):
    """The interactive scene distribution (src/sphere.c:52-59) as numpy."""
    rng = np.random.default_rng(seed)
    c = rng.uniform([-40, -20, -10], [40, 20, 5], (n, 3)).astype(np.float32)
    r = rng.uniform(0.5, 5.0, n).astype(np.float32)
    a = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    return c, r, a


@pytest.fixture(scope="module")
def problem():
    """Target image (rendered by JAX) and initial scene, for both sides."""
    jtarget_scene, _ = tp.scenes(*_interactive_np(4, 0))
    target = tp.np_(jsoft.soft_render(jtarget_scene, JCamera.default(),
                                      jsoft.SoftParams(), JCFG))
    init = _interactive_np(4, 1)
    jinit, tinit = tp.scenes(*init)
    return target, jinit, tinit


def _jax_fit(problem, steps, **kw):
    target, jinit, _ = problem
    return jfit.fit_scene(jnp.asarray(target), jinit, JCamera.default(),
                          steps=steps, config=JCFG, **kw)


def _port_fit(problem, steps, **kw):
    target, _, tinit = problem
    return fit.fit_scene(torch.as_tensor(target), tinit,
                         tt.Camera.default("cpu"), steps=steps, config=CFG,
                         **kw)


def test_checkpoint_round_trip_and_crosses_packages(tmp_path):
    tree = {"b": (torch.tensor(2.5), torch.ones(4, dtype=torch.int32)),
            "a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "c": [torch.zeros(2, 2), None]}
    p = str(tmp_path / "ck.npz")
    save_state(p, tree, meta={"step": 7, "losses": [1.0, 0.5]})
    like = {"b": (torch.tensor(0.0), torch.zeros(4, dtype=torch.int32)),
            "a": torch.zeros(2, 3), "c": [torch.ones(2, 2), None]}
    got, meta = load_state(p, like)
    assert meta == {"step": 7, "losses": [1.0, 0.5]}
    assert got["c"][1] is None and isinstance(got["b"], tuple)
    for a, b in ((got["a"], tree["a"]), (got["b"][0], tree["b"][0]),
                 (got["b"][1], tree["b"][1]), (got["c"][0], tree["c"][0])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # Same leaves in the same order as jax.tree_util: JAX reads it back.
    jtree, jmeta = load_pytree(p, jax.tree_util.tree_map(
        lambda x: jnp.asarray(tp.np_(x)), like))
    assert jmeta == meta
    for a, b in zip(jax.tree_util.tree_leaves(jtree),
                    jax.tree_util.tree_leaves(jax.tree_util.tree_map(
                        lambda x: tp.np_(x), tree))):
        np.testing.assert_array_equal(tp.np_(a), b)
    q = str(tmp_path / "jax.npz")
    save_pytree(q, {"z": jnp.ones(3), "y": (jnp.int32(4),)}, meta={"k": 1})
    got, meta = load_state(q, {"z": torch.zeros(3),
                               "y": (torch.tensor(0, dtype=torch.int32),)})
    assert meta == {"k": 1} and int(got["y"][0]) == 4
    assert torch.equal(got["z"], torch.ones(3))
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_load_rejects_mismatch(tmp_path):
    p = str(tmp_path / "ck.npz")
    save_state(p, {"a": torch.ones(3)})
    with pytest.raises(ValueError, match="leaf_0"):
        load_state(p, {"a": torch.ones(4)})
    with pytest.raises(ValueError, match="leaf_0"):
        load_state(p, {"a": torch.ones(3, dtype=torch.float64)})
    with pytest.raises(ValueError, match="structure changed"):
        load_state(p, {"a": torch.ones(3), "b": torch.ones(3)})


def test_fit_matches_jax(problem):
    """6 steps of the port's fit against the JAX fit run in float64 on the
    same f32-valued inputs: losses to rtol FIT64_RTOL (measured 2.0e-6;
    JAX's f32 fit is 3.1e-5 off float64 at its first step, its perp2
    cancelling)."""
    target, jinit, _ = problem
    with tp.x64():
        jres = jfit.fit_scene(
            tp.f64(target), tp.scene64(jinit.centers, jinit.radii,
                                       jinit.albedo),
            tp.camera64(JCamera.default()), steps=6, config=JCFG)
        assert jres.scene.centers.dtype == jnp.float64
    res = _port_fit(problem, 6)
    assert res.losses.shape == (6,) and res.step_ms.shape == (6,)
    np.testing.assert_allclose(res.losses, np.asarray(jres.losses),
                               rtol=FIT64_RTOL)
    assert res.losses[-1] < res.losses[0]


def test_jax_checkpoint_continues_in_the_port(problem, tmp_path):
    """The JAX fit runs 3 steps and checkpoints; the port reads the file,
    and its 3 further steps give the losses of the JAX 6-step run."""
    ck = str(tmp_path / "jax_fit.npz")
    _jax_fit(problem, 3, checkpoint_path=ck, checkpoint_every=100)
    full = _jax_fit(problem, 6)

    # The JAX state as fit_scene builds it, flattened with its paths: the
    # leaf order the port's reader must follow.
    _, jinit, _ = problem
    cam = JCamera.default()
    jparams = (jfit.scene_to_params(jinit), {"position": cam.position,
                                              "yaw": cam.yaw,
                                              "pitch": cam.pitch})
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(
                 (jparams, optax.adam(3e-2).init(jparams)))[0]]
    assert len(paths) == FIT_LEAVES
    stored = dict(np.load(ck))
    leaf = {p: stored[f"leaf_{i}"] for i, p in enumerate(paths)}

    (scene_p, cam_p), state, meta = fit_state_from_jax_checkpoint(
        ck, device="cpu")
    assert meta["step"] == 3
    names = [("[0][0]", k, scene_p) for k in sorted(scene_p)] \
        + [("[0][1]", k, cam_p) for k in sorted(cam_p)]
    for i, (prefix, k, d) in enumerate(names):
        np.testing.assert_array_equal(tp.np_(d[k]), leaf[f"{prefix}['{k}']"])
        st = state["state"][i]
        sub = prefix.replace("[0]", "", 1)
        assert float(st["step"]) == int(leaf["[1][0].count"])
        np.testing.assert_array_equal(tp.np_(st["exp_avg"]),
                                      leaf[f"[1][0].mu{sub}['{k}']"])
        np.testing.assert_array_equal(tp.np_(st["exp_avg_sq"]),
                                      leaf[f"[1][0].nu{sub}['{k}']"])

    # Three more steps from the read state.
    target, _, _ = problem
    params = [d[k].requires_grad_(True) for _, k, d in names]
    opt = torch.optim.Adam(params, lr=3e-2)
    opt.load_state_dict(state)
    loss_fn = fit.make_loss_fn(tt.Camera.default("cpu"), soft.SoftParams(),
                               CFG, False)
    rays = tt.camera_rays(tt.Camera.default("cpu"), CFG)
    losses = []
    for _ in range(3):
        opt.zero_grad()
        val = loss_fn((scene_p, cam_p), rays.origin.reshape(-1, 3),
                      rays.direction.reshape(-1, 3),
                      torch.as_tensor(target).reshape(-1, 3))
        val.backward()
        for p in cam_p.values():
            p.grad = torch.zeros_like(p)
        opt.step()
        losses.append(float(val.detach()))
    want = np.asarray(full.losses)[3:]
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL)

    # And the port's own fit resumes the JAX file.
    res = _port_fit(problem, 6, checkpoint_path=ck, resume=True)
    np.testing.assert_allclose(res.losses[3:], want, rtol=LOSS_RTOL)
    np.testing.assert_array_equal(res.losses[:3], np.asarray(full.losses)[:3])


def test_port_resume_is_bitwise(problem, tmp_path):
    """6 straight steps == 3 steps + checkpoint + resume to 6."""
    full = _port_fit(problem, 6)
    ck = str(tmp_path / "fit.npz")
    _port_fit(problem, 3, checkpoint_path=ck, checkpoint_every=100)
    resumed = _port_fit(problem, 6, checkpoint_path=ck, resume=True)
    np.testing.assert_array_equal(full.losses, resumed.losses)
    for f in ("centers", "radii", "albedo"):
        assert torch.equal(getattr(full.scene, f),
                           getattr(resumed.scene, f)), f


def test_cli_fit_writes_its_files(tmp_path, monkeypatch, capsys):
    """``fit --device cpu`` at 24x18 writes the four files into the working
    directory, and a run resumed from its checkpoint ends where a straight
    run does."""
    monkeypatch.chdir(tmp_path)
    base = ["fit", "--device", "cpu", "--width", str(W), "--height", str(H)]
    assert cli.main(base + ["--steps", "3"]) == 0
    out = capsys.readouterr().out
    assert "ms/step on cpu" in out
    for name in ("fit_target.png", "fit_init.png", "fit_final.png"):
        with open(name, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n", name
    straight = np.loadtxt("fit_losses.txt")
    assert straight.shape == (3,) and straight[-1] < straight[0]

    assert cli.main(base + ["--steps", "2", "--checkpoint", "ck.npz"]) == 0
    assert cli.main(base + ["--steps", "3", "--checkpoint", "ck.npz",
                            "--resume"]) == 0
    np.testing.assert_array_equal(np.loadtxt("fit_losses.txt"), straight)


def _camera_problem():
    """(scene, true camera, perturbed camera, target, scene depth) of the
    camera fit: 8 spheres of the interactive distribution, the target their
    soft image at the default pose."""
    scene = tt.scene_from_numpy(*_interactive_np(8, 2), device="cpu")
    cam = tt.Camera.default("cpu")
    off = cam.replace(yaw=cam.yaw + YAW_OFF,
                      position=cam.position + torch.tensor(POS_OFF))
    with torch.no_grad():
        target = soft.soft_render(scene, cam, soft.SoftParams(), CAM_CFG)
    depth = float(torch.mean(torch.linalg.vector_norm(
        scene.centers - cam.position, dim=1)))
    return scene, cam, off, target, depth


def test_camera_gradient_matches_jax_soft_render():
    """The fit's loss with optimize_camera=True (rays made from the pose
    parameters at ``pixel_uv``), differentiated with respect to position,
    yaw and pitch at the perturbed pose, against ``jax.grad`` of JAX's
    ``soft_render`` with ``rays=None`` (its rays made from the camera, so
    its gradient reaches the pose), run in float64 on the same values: to
    CAM_GRAD_RTOL of the largest component (measured 2.7e-5, pitch)."""
    scene, _, off, target, _ = _camera_problem()
    scene_p = fit.scene_to_params(scene)
    cam_p = {k: getattr(off, k).clone().requires_grad_(True) for k in POSE}
    uv = tuple(x.reshape(-1) for x in tt.scene.camera.pixel_uv(CAM_CFG,
                                                                "cpu"))
    loss_fn = fit.make_loss_fn(off, soft.SoftParams(), CAM_CFG, True)
    val = loss_fn((scene_p, cam_p), None, None, target.reshape(-1, 3),
                  uv=uv)
    grads = torch.autograd.grad(val, [cam_p[k] for k in POSE])

    seen = fit.params_to_scene(scene_p)
    with tp.x64():
        js = tp.scene64(seen.centers, seen.radii, seen.albedo)
        jcam = tp.camera64(JCamera.default()).replace(
            **{k: tp.f64(getattr(off, k)) for k in POSE})
        jtarget = tp.f64(target)

        def jloss(position, yaw, pitch):
            img = jsoft.soft_render(js, jcam.replace(
                position=position, yaw=yaw, pitch=pitch), jsoft.SoftParams(),
                CAM_JCFG)
            return jnp.mean((img - jtarget) ** 2)

        jval, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
            *(getattr(jcam, k) for k in POSE))
        assert jval.dtype == jnp.float64
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-5)
    for name, g, jg in zip(POSE, grads, jgrads):
        jg = tp.np_(jg)
        assert np.abs(jg).max() > 0, name
        np.testing.assert_allclose(tp.np_(g), jg, rtol=0, err_msg=name,
                                   atol=CAM_GRAD_RTOL * np.abs(jg).max())


def test_camera_fit_shrinks_the_pose_error():
    """From the perturbed pose the fit with optimize_camera=True brings the
    pose back: its view error (``fit.view_error``) falls to under half
    (measured 0.0218 -> 0.0068 rad: the yaw error 0.02 -> 0.004, while the
    sideways shift, which the yaw and the centres can stand in for at this
    depth, stays near 0.1) and the loss to under a quarter (measured
    0.11); without optimize_camera the camera comes back as it was passed,
    the same tensors."""
    scene, cam, off, target, depth = _camera_problem()
    res = fit.fit_scene(target, scene, off, steps=CAM_STEPS, lr=CAM_LR,
                        config=CAM_CFG, optimize_camera=True)
    before = fit.view_error(off, cam, depth)
    after = fit.view_error(res.camera, cam, depth)
    assert after < before / 2, (before, after)
    assert res.losses[-1] < 0.25 * res.losses[0]
    still = fit.fit_scene(target, scene, off, steps=2, lr=CAM_LR,
                          config=CAM_CFG)
    assert all(getattr(still.camera, k) is getattr(off, k)
               for k in ("position", "yaw", "pitch", "fov"))


def test_camera_fit_resume_is_bitwise(tmp_path):
    """With optimize_camera=True, 6 straight steps == 3 steps + checkpoint
    + resume to 6, the pose included."""
    scene, _, off, target, _ = _camera_problem()

    def run(steps, **kw):
        return fit.fit_scene(target, scene, off, steps=steps, lr=CAM_LR,
                             config=CAM_CFG, optimize_camera=True, **kw)
    full = run(6)
    ck = str(tmp_path / "fit.npz")
    run(3, checkpoint_path=ck, checkpoint_every=100)
    resumed = run(6, checkpoint_path=ck, resume=True)
    np.testing.assert_array_equal(full.losses, resumed.losses)
    for k in POSE:
        assert torch.equal(getattr(full.camera, k),
                           getattr(resumed.camera, k)), k
    assert not torch.equal(full.camera.yaw, off.yaw)
