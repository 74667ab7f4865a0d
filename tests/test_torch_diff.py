"""PyTorch port vs the JAX package: the dense soft renderer and its
gradients (``tracer_torch.diff.soft``).

The same numpy scene goes to ``tracer.diff.soft`` and to the port on a
24x18 frame. Tolerances: images atol 1e-5 (XLA on the CPU contracts
mul+add into FMA where torch rounds each op, a few ulps); gradients atol
1e-4 * max|g_JAX| + 1e-7, through torch autograd against ``jax.grad``, for
centres, radii, albedo and the camera's yaw, pitch and position. The port's
own gradients are also held against central finite differences with the
JAX test's bounds (tests/test_diff.py), the streaming form against JAX's,
the sharp limit against the hard silhouette, and a pixel sitting exactly on
the clip bound against JAX's gradient there (half through ``jnp.clip`` at
a tie, where ``torch.clamp`` would pass all of it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tracer_torch as tt
from tests import torch_parity as tp
from tests.torch_parity import one_thread  # noqa: F401
from tracer.config import TracerConfig as JConfig
from tracer.diff import soft as jsoft
from tracer.scene.camera import Camera as JCamera
from tracer.scene.camera import camera_rays as j_camera_rays
from tracer_torch.config import TracerConfig
from tracer_torch.diff import soft
from tracer_torch.interop import soft_params_from_numpy

W, H = 24, 18
JCFG = JConfig(width=W, height=H, max_depth=1)
CFG = TracerConfig(width=W, height=H, max_depth=1)
IMG_ATOL = 1e-5
GRAD_RTOL = 1e-4     # of max |g_JAX|
GRAD_ATOL = 1e-7


def _simple_np():
    """tests/test_diff.py's two spheres."""
    c = np.array([[0.0, 4.0, 30.0], [3.0, 2.0, 28.0]], np.float32)
    r = np.array([2.0, 1.5], np.float32)
    a = np.array([[0.8, 0.2, 0.2], [0.1, 0.6, 0.9]], np.float32)
    return c, r, a


def _crowd_np(n=7, seed=4):
    """n overlapping spheres in front of the default camera."""
    rng = np.random.default_rng(seed)
    c = rng.uniform([-6, -2, 18], [6, 9, 34], (n, 3)).astype(np.float32)
    r = rng.uniform(1.0, 3.0, n).astype(np.float32)
    a = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    return c, r, a


SCENES = {"simple": _simple_np, "crowd": _crowd_np}
PARAMS = {"test_diff": (8.0, 0.5, 0.05), "defaults": (50.0, 0.05, 0.05)}


def _params(name):
    e, t, s = PARAMS[name]
    return (jsoft.SoftParams(edge_sharpness=jnp.float32(e),
                             tau_depth=jnp.float32(t),
                             smooth_eps=jnp.float32(s)),
            soft_params_from_numpy(e, t, s))


def _weights():
    return np.linspace(0, 1, H * W * 3, dtype=np.float32).reshape(H, W, 3)


def _assert_grad_close(g, g_jax, name):
    g, g_jax = tp.np_(g), tp.np_(g_jax)
    assert np.isfinite(g).all(), name
    np.testing.assert_allclose(
        g, g_jax, atol=GRAD_RTOL * np.abs(g_jax).max() + GRAD_ATOL,
        rtol=0, err_msg=name)


@pytest.mark.parametrize("params", sorted(PARAMS))
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_soft_image_and_gradients_match_jax(scene, params):
    """The image, and d(sum(img * w))/d(field) for every scene field and
    the camera pose, against jax.grad on the same inputs."""
    c, r, a = SCENES[scene]()
    jscene, tscene = tp.scenes(c, r, a)
    jp, tp_ = _params(params)
    jcam, tcam = JCamera.default(), tt.Camera.default("cpu")
    w = _weights()

    def jloss(centers, radii, albedo, yaw, pitch, position):
        s = jscene.replace(centers=centers, radii=radii, albedo=albedo)
        cam = jcam.replace(yaw=yaw, pitch=pitch, position=position)
        img = jsoft.soft_render(s, cam, jp, JCFG)
        return jnp.sum(img * w), img

    jargs = (jscene.centers, jscene.radii, jscene.albedo, jcam.yaw,
             jcam.pitch, jcam.position)
    (_, jimg), jgrads = jax.value_and_grad(jloss, argnums=tuple(range(6)),
                                           has_aux=True)(*jargs)

    targs = [x.clone().requires_grad_(True) for x in
             (tscene.centers, tscene.radii, tscene.albedo, tcam.yaw,
              tcam.pitch, tcam.position)]
    s = tt.Scene(centers=targs[0], radii=targs[1], albedo=targs[2])
    cam = tcam.replace(yaw=targs[3], pitch=targs[4], position=targs[5])
    img = soft.soft_render(s, cam, tp_, CFG)
    np.testing.assert_allclose(tp.np_(img), tp.np_(jimg), atol=IMG_ATOL,
                               rtol=0)
    torch.sum(img * torch.as_tensor(w)).backward()
    names = ("centers", "radii", "albedo", "yaw", "pitch", "position")
    for name, t, g in zip(names, targs, jgrads):
        assert np.abs(tp.np_(g)).max() > 0, name
        _assert_grad_close(t.grad, g, name)


def _fd_grad(f, x, eps):
    """Central finite differences of scalar f at array x (f32 inputs)."""
    x = np.asarray(x, np.float64)
    g = np.zeros_like(x)
    for i in np.ndindex(x.shape):
        xp, xm = x.copy(), x.copy()
        xp[i] += eps
        xm[i] -= eps
        g[i] = (f(xp.astype(np.float32)) - f(xm.astype(np.float32))) \
            / (2 * eps)
    return g


@pytest.mark.parametrize("field,eps,rtol", [
    ("centers", 1e-2, 0.10),
    ("radii", 1e-2, 0.15),
    ("albedo", 1e-2, 0.05),
])
def test_gradients_match_finite_differences(field, eps, rtol):
    """tests/test_diff.py's FD check, on the port: autograd against
    central differences within rtol * max|g_FD|."""
    c, r, a = _simple_np()
    tscene = tt.scene_from_numpy(c, r, a, device="cpu")
    cam = tt.Camera.default("cpu")
    params = soft.SoftParams(edge_sharpness=8.0, tau_depth=0.5)
    w = torch.as_tensor(_weights())

    def loss(value):
        s = tt.Scene(**{**vars(tscene), field: value})
        return torch.sum(soft.soft_render(s, cam, params, CFG) * w)

    with torch.no_grad():
        g_fd = _fd_grad(lambda v: float(loss(torch.as_tensor(v))),
                        tp.np_(getattr(tscene, field)), eps)
    x = getattr(tscene, field).clone().requires_grad_(True)
    loss(x).backward()
    g = tp.np_(x.grad)
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 1e-6, "gradient is identically zero"
    np.testing.assert_allclose(g, g_fd, atol=rtol * np.abs(g_fd).max())


def test_streaming_form_matches_jax():
    """soft_max_logit, soft_accumulate and soft_finalize on the frame's
    rays against JAX: values to f32 rounding (rtol 1e-5 on the partial
    sums, IMG_ATOL on the image), and the image's centre gradient to
    GRAD_RTOL."""
    c, r, a = _crowd_np()
    jscene, tscene = tp.scenes(c, r, a)
    jp, tp_ = _params("test_diff")
    jr = j_camera_rays(JCamera.default(), JCFG)
    o = tp.np_(jr.origin).reshape(-1, 3)
    d = tp.np_(jr.direction).reshape(-1, 3)
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    to, td = torch.as_tensor(o), torch.as_tensor(d)

    jm = jsoft.soft_max_logit(jscene, jo, jd, jp)
    m = soft.soft_max_logit(tscene, to, td, tp_)
    np.testing.assert_allclose(tp.np_(m), tp.np_(jm), rtol=1e-5, atol=1e-5)

    def jimage(centers):
        s = jscene.replace(centers=centers)
        acc, den, lt = jsoft.soft_accumulate(s, jo, jd, jp, jm)
        return jsoft.soft_finalize(acc, den, lt, jd, jp), (acc, den, lt)

    (jimg, jparts) = jimage(jscene.centers)
    centers = tscene.centers.clone().requires_grad_(True)
    s = tt.Scene(centers=centers, radii=tscene.radii, albedo=tscene.albedo)
    parts = soft.soft_accumulate(s, to, td, tp_, m)
    for x, jx in zip(parts, jparts):
        np.testing.assert_allclose(tp.np_(x), tp.np_(jx), rtol=1e-5,
                                   atol=1e-6)
    img = soft.soft_finalize(*parts, td, tp_)
    np.testing.assert_allclose(tp.np_(img), tp.np_(jimg), atol=IMG_ATOL,
                               rtol=0)
    wt = _weights().reshape(-1, 3)
    jg = jax.grad(lambda cc: jnp.sum(jimage(cc)[0] * wt))(jscene.centers)
    torch.sum(img * torch.as_tensor(wt)).backward()
    _assert_grad_close(centers.grad, jg, "centers")


def test_soft_converges_to_hard_silhouette():
    """tests/test_diff.py's limit on the port: at sharpness 5000 and tau
    0.001, pixels that miss every sphere by over 5% of its radius show the
    sky within 2e-2."""
    c, r, a = _simple_np()
    tscene = tt.scene_from_numpy(c, r, a, device="cpu")
    cam = tt.Camera.default("cpu")
    sharp = soft.SoftParams(edge_sharpness=5000.0, tau_depth=0.001)
    img = tp.np_(soft.soft_render(tscene, cam, sharp, CFG))
    rays = tt.camera_rays(cam, CFG)
    hard = tp.np_(tt.nearest_hit_brute(rays, tscene).hit)
    o = tp.np_(rays.origin).reshape(-1, 3)
    d = tp.np_(rays.direction).reshape(-1, 3)
    oc = c[None] - o[:, None]
    t_ca = (oc * d[:, None]).sum(-1)
    perp = np.sqrt(np.maximum((oc * oc).sum(-1) - t_ca ** 2, 0.0))
    away = (np.abs(perp - r[None]) / r[None]).min(-1).reshape(hard.shape) \
        > 0.05
    sky = tp.np_(tt.sky_color(rays.direction))
    sky_px = ~hard & away
    assert sky_px.sum() > 50
    np.testing.assert_allclose(img[sky_px], sky[sky_px], atol=2e-2)


def test_gradient_at_the_clip_bound_splits_like_jax():
    """A sphere with blue albedo 0.5 shades blue to exactly 1.0, so its
    covered pixels composite to 1.0 in blue and sit on the clip bound,
    where jnp.clip passes half the gradient. The blue channel's Jacobian
    with respect to albedo equals JAX's at every pixel, ties included, and
    is half of the unclipped composite's there."""
    c = np.array([[0.0, 4.0, 30.0]], np.float32)
    r = np.array([2.5], np.float32)
    a = np.array([[0.3, 0.7, 0.5]], np.float32)
    jscene, tscene = tp.scenes(c, r, a)
    jp, tp_ = _params("test_diff")
    jrays = j_camera_rays(JCamera.default(), JCFG)
    rays = tt.camera_rays(tt.Camera.default("cpu"), CFG)

    def jblue(albedo):
        return jsoft.soft_render(jscene.replace(albedo=albedo), None, jp,
                                 rays=jrays)[..., 2].reshape(-1)

    def blue(albedo, clipped=True):
        s = tt.Scene(centers=tscene.centers, radii=tscene.radii,
                     albedo=albedo)
        if clipped:
            return soft.soft_render(s, None, tp_, rays=rays)[..., 2] \
                .reshape(-1)
        o, d = rays.origin.reshape(-1, 3), rays.direction.reshape(-1, 3)
        sigma, shade, t_soft = soft._shade_sigma_t(s, o, d, tp_)
        order = torch.argsort(t_soft, dim=-1, stable=True)
        sig = torch.gather(sigma * (1.0 - 1e-6), -1, order)
        log1m = torch.log1p(-sig)
        w = sig * torch.exp(torch.cumsum(log1m, -1) - log1m)
        shade_b = torch.gather(shade[..., 2], -1, order)
        return torch.sum(w * shade_b, -1) \
            + torch.exp(log1m.sum(-1)) * tt.sky_color(d)[:, 2]

    jval = tp.np_(jblue(jscene.albedo))
    jjac = tp.np_(jax.jacrev(jblue)(jscene.albedo))[:, 0, 2]
    val = tp.np_(blue(tscene.albedo))
    raw_val = tp.np_(blue(tscene.albedo, clipped=False))
    jac = tp.np_(torch.autograd.functional.jacobian(
        blue, tscene.albedo))[:, 0, 2]
    raw = tp.np_(torch.autograd.functional.jacobian(
        lambda x: blue(x, clipped=False), tscene.albedo))[:, 0, 2]
    # Rounding decides which pixels land exactly on 1.0; JAX sits on the
    # bound where its value is 1.0 and its gradient is not cut to 0.
    tie = raw_val == 1.0
    jtie = (jval == 1.0) & (jjac != 0)
    both = tie & jtie
    assert both.sum() >= 100, "too few pixels on the bound"
    assert (tie != jtie).sum() <= 0.05 * tie.size
    np.testing.assert_allclose(jac[both], 0.5 * raw[both], rtol=1e-6)
    same = both | ((val < 1.0) & (jval < 1.0))
    assert same.sum() >= 0.9 * same.size
    np.testing.assert_allclose(jac[same], jjac[same],
                               atol=GRAD_RTOL * np.abs(jjac).max()
                               + GRAD_ATOL, rtol=0)
