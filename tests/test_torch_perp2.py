"""The soft model's perp2 on small spheres far from the rays' origins.

The JAX package takes the squared distance of a sphere's centre from a ray
as perp2 = |oc|^2 - t_ca^2 |d|^2 (``tracer/diff/soft.py``,
``tracer/diff/sparse.py``), which cancels two terms of size |oc|^2: at
hundreds of units an ulp of them is a large part of r^2 = 0.25, and the
edge sharpness turns that into sigma errors of order 1 at silhouettes. The
port takes the length of the perpendicular vector oc - t_ca d
(``soft.soft_terms``, ``sparse._sigma_t_scalar``). Both forms are held
against the JAX functions run in float64 (``torch_parity.x64``) on the same
f32 inputs: spheres of r = 0.5 at 300-900 units in every direction, rays
from within 2 units of the origin aimed at their silhouettes.

Each case holds the port's f32 sigma over every (ray, sphere) pair and its
image to float64 within SIGMA_ATOL and IMG_ATOL, and shows the fault it
repairs: JAX's f32 misses float64 by more than MISS in both. Measured on
these inputs: the port's sigma within 5.4e-4 of float64 and its images
within 2.2e-4, in every case; JAX's f32 sigma off by 0.99, its images by
0.45-0.48.

The reference's rays are float64 too (their f32 values): with f32 rays,
|d|^2 stays f32 in JAX's float64 run, and |oc|^2 - (oc.d)^2 / |d|^2 then
cancels an f32 rounding of |d|^2 times |oc|^2.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tracer_torch as tt
from tests import torch_parity as tp
from tests.torch_parity import one_thread  # noqa: F401
from tracer.core.sort import prep_rays_bucketed as j_prep_rays
from tracer.core.types import Ray as JRay
from tracer.diff import soft as jsoft
from tracer.diff import sparse as jsparse
from tracer.kernels import leafcull as jleaf
from tracer_torch.diff import soft, sparse

SP = 64
SIGMA_ATOL = 2e-3    # port f32 against JAX float64
IMG_ATOL = 1e-3
MISS = 0.1           # JAX f32 against JAX float64, at least
N_SPHERES, N_RAYS, LEAF = 128, 256, 8


def _far_problem(seed=0):
    """(centres, radii, albedo, origins, unit directions): N_SPHERES
    spheres of r = 0.5 at 300-900 units in random directions, N_RAYS rays
    from within 2 units of the origin, two aimed at each sphere's
    silhouette (0.9-1.1 r off its centre, across the ray)."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(N_SPHERES, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    c = (u * rng.uniform(300, 900, N_SPHERES)[:, None]).astype(np.float32)
    r = np.full(N_SPHERES, 0.5, np.float32)
    a = rng.uniform(0, 1, (N_SPHERES, 3)).astype(np.float32)
    o = rng.uniform(-2, 2, (N_RAYS, 3)).astype(np.float32)
    k = np.arange(N_RAYS) % N_SPHERES
    oc = (c[k] - o).astype(np.float64)
    q = rng.normal(size=(N_RAYS, 3))
    q -= (q * oc).sum(1, keepdims=True) / (oc * oc).sum(1, keepdims=True) \
        * oc
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    d = oc + rng.uniform(0.9, 1.1, (N_RAYS, 1)) * r[k][:, None] * q
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return c, r, a, o, d


@pytest.fixture(scope="module")
def far():
    c, r, a, o, d = _far_problem()
    jscene, tscene = tp.scenes(c, r, a)
    scale = sparse.soft_radius_scale(soft.SoftParams())
    jb, tb = tp.bvhs(c, r * np.float32(scale), LEAF)
    padded, _ = j_prep_rays(JRay(origin=jnp.asarray(o),
                                 direction=jnp.asarray(d)), SP, cell_bits=4)
    return {"np": (c, r, a, o, d), "jscene": jscene, "tscene": tscene,
            "jt": jleaf.build_cull_tables(jscene, jb, leaves_per_group=16),
            "tt": tt.build_cull_tables(tscene, tb, leaves_per_group=16),
            "padded": (tp.np_(padded.origin), tp.np_(padded.direction))}


def _dense_sigma(mod, scene, o, d, params):
    if mod is soft:
        return soft._shade_sigma_t(scene, o, d, params)[0]
    return jsoft._logits_and_shade(scene, o, d, params)[2]


def _scalar_sigma(mod, scene, o, d, params):
    """sigma of every (ray, sphere) pair through the scalar form, rays
    (B, 1) against spheres (1, N)."""
    c, r = scene.centers, scene.radii
    cs = [c[None, :, i] for i in range(3)]
    os_ = [o[:, i:i + 1] for i in range(3)]
    ds = [d[:, i:i + 1] for i in range(3)]
    a = (d * d).sum(1)[:, None]
    if mod is sparse:
        return sparse._sigma_t_scalar(*cs, r[None], *os_, *ds, a, params)[0]
    od = (o * d).sum(1)[:, None]
    oo = (o * o).sum(1)[:, None]
    c2 = (c * c).sum(1)[None]
    return jsparse._sigma_t_scalar(*cs, c2, r[None], *os_, *ds, od, oo, a,
                                   params)[0]


def _dense_image(mod, scene, tables, o, d, params):
    ray = (tt.Ray if mod is soft else JRay)(origin=o, direction=d)
    return mod.soft_render(scene, None, params, rays=ray)


def _sparse_image(name):
    def image(mod, scene, tables, o, d, params):
        kw = {"top_m": 16} if name == "fast" else {}
        img, ovf = getattr(mod, f"soft_render_sparse_{name}")(
            scene, o, d, tables, params, max_leaves=64, subpacket=SP, **kw)
        assert not bool(ovf)
        return img
    return image


# case -> (sigma form, image, image on the padded (sorted) rays?)
CASES = {
    "dense": (_dense_sigma, _dense_image, False),
    "packets": (_dense_sigma, _sparse_image("packets"), True),
    "leaforder": (_scalar_sigma, _sparse_image("leaforder"), True),
    "fast": (_scalar_sigma, _sparse_image("fast"), True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_far_silhouettes_match_float64(far, case):
    sigma_of, image_of, padded = CASES[case]
    c, r, a, o, d = far["np"]
    io, id_ = far["padded"] if padded else (o, d)
    jmod = jsoft if sigma_of is _dense_sigma else jsparse
    tmod = soft if sigma_of is _dense_sigma else sparse
    imod = (soft, jsoft) if image_of is _dense_image else (sparse, jsparse)

    out = {}
    for mode in ("f32", "f64"):
        with tp.x64() if mode == "f64" else contextlib.nullcontext():
            if mode == "f64":
                js = tp.scene64(c, r, a)
                jo, jd = tp.f64(o), tp.f64(d)
            else:
                js = far["jscene"]
                jo, jd = jnp.asarray(o), jnp.asarray(d)
            sig = sigma_of(jmod, js, jo, jd, jsoft.SoftParams())
            img = image_of(imod[1], js, far["jt"], *(
                tp.f64(x) if mode == "f64" else jnp.asarray(x)
                for x in (io, id_)), jsoft.SoftParams())
            assert (sig.dtype == jnp.float64) == (mode == "f64")
            assert (img.dtype == jnp.float64) == (mode == "f64")
            out[mode] = (tp.np_(sig), tp.np_(img))
    ts = far["tscene"]
    with torch.no_grad():
        sig = tp.np_(sigma_of(tmod, ts, torch.as_tensor(o),
                              torch.as_tensor(d), soft.SoftParams()))
        img = tp.np_(image_of(imod[0], ts, far["tt"], torch.as_tensor(io),
                              torch.as_tensor(id_), soft.SoftParams()))
    (j32_sig, j32_img), (ref_sig, ref_img) = out["f32"], out["f64"]

    aimed = ref_sig[np.arange(N_RAYS), np.arange(N_RAYS) % N_SPHERES]
    assert (aimed > 0.1).sum() >= N_RAYS // 4 and (aimed < 0.9).any()
    np.testing.assert_allclose(sig, ref_sig, atol=SIGMA_ATOL, rtol=0)
    np.testing.assert_allclose(img, ref_img, atol=IMG_ATOL, rtol=0)
    assert np.abs(j32_sig - ref_sig).max() > MISS
    assert np.abs(j32_img - ref_img).max() > MISS
