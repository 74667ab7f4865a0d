"""Smoothed-visibility differentiable rendering.

PyTorch counterpart of ``tracer/diff/soft.py``. The hard integrator's pixels
depend on geometry only through discontinuous visibility, so its gradient
with respect to centres, radii and pose is zero almost everywhere. The soft
model replaces both discontinuities:

  1. **Silhouette**: the hit test ``disc > 0`` becomes a sigmoid of the
     signed silhouette distance (perpendicular ray-centre distance minus
     radius), so silhouettes get finite-width differentiable edges.
  2. **Occlusion**: the argmin over t becomes depth-ordered alpha
     compositing ``img = sum_i sigma_i T_i shade_i + T sky`` with
     ``T_i = prod_{t_j < t_i} (1 - sigma_j)`` (:func:`composite_sorted`).

As ``edge_sharpness -> inf`` and ``tau_depth -> 0`` the soft image tends to
the hard depth-1 image. Everything is plain torch over (rays, spheres), so
autograd reaches centres, radii, albedo and the camera pose (through ray
generation).

The streaming form (:func:`soft_max_logit`, :func:`soft_accumulate`,
:func:`soft_finalize`) is the SoftRas-style depth softmax in two passes, a
max-logit pass then an exp-sum pass, which decomposes exactly over sphere
shards; the scene-sharded trainer reduces its partials across shards.

Clips and maxima that are differentiated are written with
``torch.maximum``/``torch.minimum`` against a 0-d tensor (:func:`maximum`,
:func:`clip`): at a tie they give each side half the gradient, as
``jnp.maximum`` and ``jnp.clip`` do, where ``torch.clamp`` gives all of it
to the input. Pure-sky pixels composite to exactly 1.0 in the blue channel
and sit on that tie.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import Tensor

from tracer_torch.config import DEFAULT_CONFIG, TracerConfig
from tracer_torch.core import vecmath
from tracer_torch.core.types import Ray
from tracer_torch.integrator.wavefront import sky_color
from tracer_torch.scene.camera import Camera, camera_rays
from tracer_torch.scene.scene import Scene


@dataclass(frozen=True)
class SoftParams:
    """Smoothing temperatures. edge_sharpness is in units of 1/radius (50
    makes the silhouette edge ~2% of the radius wide); tau_depth is in world
    units (occlusion softness along the ray); smooth_eps, relative to each
    sphere's radius, caps the sqrt-gradient blowups at rays through a
    sphere's centre and at grazing incidence."""

    edge_sharpness: float = 50.0
    tau_depth: float = 0.05
    smooth_eps: float = 0.05


def maximum(x: Tensor, c: float) -> Tensor:
    """``jnp.maximum(x, c)``: half the gradient to x where x == c."""
    return torch.maximum(x, torch.full((), c, dtype=x.dtype, device=x.device))


def minimum(x: Tensor, c: float) -> Tensor:
    """``jnp.minimum(x, c)``: half the gradient to x where x == c."""
    return torch.minimum(x, torch.full((), c, dtype=x.dtype, device=x.device))


def clip(x: Tensor, lo: float, hi: float) -> Tensor:
    """``jnp.clip(x, lo, hi)``, with its gradient of 0.5 on either bound."""
    return minimum(maximum(x, lo), hi)


def _sigmoid(x: Tensor) -> Tensor:
    return 1.0 / (1.0 + torch.exp(clip(-x, -30.0, 30.0)))


def soft_terms(o: Tensor, d: Tensor, c: Tensor, r: Tensor, albedo: Tensor,
               params: SoftParams):
    """Soft coverage, shade and depth of (ray, sphere) pairs, for operands
    that broadcast against each other: rays o/d (..., 1, 3) against
    spheres c/albedo (..., K, 3) and r (..., K). Returns sigma (..., K),
    shade (..., K, 3) and t_soft (..., K)."""
    oc = c - o
    a = vecmath.dot(d, d)
    t_ca = vecmath.dot(oc, d) / maximum(a, 1e-30)
    perp2 = maximum(vecmath.dot(oc, oc) - t_ca * t_ca * a, 0.0)
    eps2 = (params.smooth_eps * r) ** 2
    # sqrt smoothed at the radius scale: a bounded gradient even for rays
    # through a sphere's centre (perp2 -> 0).
    perp = torch.sqrt(perp2 + eps2)
    sdf = (perp - r) / maximum(r, 1e-6)
    sigma = _sigmoid(-sdf * params.edge_sharpness)

    disc = r * r - perp2
    # Smoothed hit depth: t_ca - sqrt(disc) away from grazing, smooth
    # through disc -> 0, t_ca where the ray misses; the offset keeps it
    # continuous at disc = 0.
    sq = torch.sqrt(maximum(disc, 0.0) + eps2) - params.smooth_eps * r
    t_soft = t_ca - sq / torch.sqrt(maximum(a, 1e-30))
    # Spheres behind the origin fade out smoothly.
    sigma = sigma * _sigmoid(t_soft * params.edge_sharpness)

    p = o + t_soft[..., None] * d
    n = vecmath.normalize(p - c)
    mirror = vecmath.reflect(torch.broadcast_to(d, n.shape), n)
    # Deterministic analog of base + 0.5 * bounce (src/renderer.c:56-58)
    # along the mirror direction.
    shade = albedo + 0.5 * sky_color(mirror)
    return sigma, shade, t_soft


def _shade_sigma_t(scene: Scene, o: Tensor, d: Tensor, params: SoftParams):
    """Every (ray, sphere) pair: o, d (B, 3) -> sigma (B, N), shade
    (B, N, 3), t_soft (B, N)."""
    return soft_terms(o[:, None, :], d[:, None, :], scene.centers[None],
                      scene.radii[None], scene.albedo[None], params)


def composite_sorted(sigma: Tensor, shade: Tensor, t_soft: Tensor,
                     d: Tensor) -> Tensor:
    """Depth-ordered alpha compositing over the last candidate axis.

    sigma/t_soft (..., K), shade (..., K, 3), d (..., 3) ray directions.
    Returns the colour (..., 3):

        img = sum_i sigma_i * T_i * shade_i + T_total * sky,
        T_i = prod_{j : t_j < t_i} (1 - sigma_j)

    The sort is stable, as ``jnp.argsort``; its indices are piecewise
    constant, and values and gradients flow through the gathers.
    """
    order = torch.argsort(t_soft, dim=-1, stable=True)
    sig_s = torch.gather(sigma * (1.0 - 1e-6), -1, order)
    shade_s = torch.gather(shade, -2,
                           order[..., None].expand(*order.shape, 3))
    log1m = torch.log1p(-sig_s)
    log_t = torch.cumsum(log1m, dim=-1) - log1m         # exclusive prefix
    w = sig_s * torch.exp(log_t)
    img = torch.sum(w[..., None] * shade_s, dim=-2)
    t_total = torch.exp(torch.sum(log1m, dim=-1))[..., None]
    return clip(img + t_total * sky_color(d), 0.0, 1.0)


def _logits(sigma: Tensor, t_soft: Tensor, params: SoftParams) -> Tensor:
    """Depth-softmax logits log(sigma) - t / tau, (B, N)."""
    return torch.log(sigma + 1e-30) - t_soft / params.tau_depth


def soft_max_logit(scene: Scene, o: Tensor, d: Tensor,
                   params: SoftParams) -> Tensor:
    """Pass 1: per-ray max logit over this sphere shard, (B,); reduce the
    partial maxima across scene shards before pass 2."""
    sigma, _, t_soft = _shade_sigma_t(scene, o, d, params)
    return torch.amax(_logits(sigma, t_soft, params), dim=1)


def soft_accumulate(scene: Scene, o: Tensor, d: Tensor, params: SoftParams,
                    m: Tensor):
    """Pass 2: partial (sum w*shade (B, 3), sum w (B,), sum log(1-sigma)
    (B,)) of this sphere shard with w = exp(l - m); sum all three across
    scene shards. m is the per-ray global max logit, detached (the softmax
    is shift-invariant)."""
    sigma, shade, t_soft = _shade_sigma_t(scene, o, d, params)
    w = torch.exp(_logits(sigma, t_soft, params) - m.detach()[:, None])
    acc = torch.sum(w[..., None] * shade, dim=1)
    den = torch.sum(w, dim=1)
    log_trans = torch.sum(torch.log1p(-sigma * (1.0 - 1e-6)), dim=1)
    return acc, den, log_trans


def soft_finalize(acc: Tensor, den: Tensor, log_trans: Tensor, d: Tensor,
                  params: SoftParams) -> Tensor:
    """Blend the depth-softmax sphere colour with the sky through the
    transmittance T = prod(1 - sigma) -> (B, 3)."""
    t_bg = torch.exp(log_trans)[:, None]
    sphere_color = acc / (den + 1e-20)[:, None]
    img = (1.0 - t_bg) * sphere_color + t_bg * sky_color(d)
    return clip(img, 0.0, 1.0)


def soft_render(scene: Scene, camera: Camera | None,
                params: SoftParams | None = None,
                config: TracerConfig = DEFAULT_CONFIG,
                rays: Ray | None = None) -> Tensor:
    """Differentiable soft image: (H, W, 3), or rays' batch shape + (3,)
    when ``rays`` is given (the camera is then not read)."""
    if params is None:
        params = SoftParams()
    if rays is None:
        rays = camera_rays(camera, config)
    batch_shape = rays.batch_shape
    o = rays.origin.reshape(-1, 3)
    d = rays.direction.reshape(-1, 3)
    sigma, shade, t_soft = _shade_sigma_t(scene, o, d, params)
    img = composite_sorted(sigma, shade, t_soft, d)
    return img.reshape(*batch_shape, 3)
