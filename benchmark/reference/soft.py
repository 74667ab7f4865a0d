"""The soft image, its loss and its gradients: every ray against every
sphere.

The smoothed-visibility model of the inverse-rendering path, written out
from its equations, for rays o, d and spheres c, r, albedo with the
parameters s (edge sharpness), eps (smoothing, relative to the radius):

    oc = c - o,  a = |d|^2,  t_ca = (oc . d) / max(a, 1e-30)
    q = oc - t_ca d,  perp2 = max(|q|^2, 0),  perp = sqrt(perp2 + (eps r)^2)
    disc = r^2 - perp2
    t = t_ca - (sqrt(max(disc, 0) + (eps r)^2) - eps r) / sqrt(max(a, 1e-30))
    sigma = sig(-s (perp - r) / max(r, 1e-6)) * sig(s t)
    sig(x) = 1 / (1 + exp(clip(-x, -30, 30)))
    n = normalize(o + t d - c),  m = d - 2 (d . n) n
    shade = albedo + 0.5 sky(m),  sky(v) = (1 - u) + u (128/255, 178/255, 1)
        with u = 0.5 (v_y + 1)

and per ray, the spheres in stable order of t, alpha compositing:

    img = clip(sum_i a_i T_i shade_i + T sky(d), 0, 1),
    a_i = sigma_i (1 - 1e-6),  T_i = prod_{j before i} (1 - a_j),
    T = prod_i (1 - a_i)

The loss is the mean of (img - target)^2 over every ray and channel; its
gradients with respect to the centres, radii and albedo come from
autograd. No tree and no table: each block of rays meets every sphere.

Left out, ray by ray: the spheres whose sigma is at most the clip's floor
sig(-30) = 9.36e-14 (a dense pass without autograd finds the others).
Leaving out a sphere of sigma at most f moves the pixel by at most
f * 1.45 (the largest shade, 0.95 + 0.5, or sky), so the N spheres of a
scene move it by at most N * 1.36e-13: 1.4e-8 at 100,000 spheres. Such a
sphere's sigma has one of its two sigmoids clipped, so its gradient is
f times the other's derivative, at most 50 f / r per unit: none that
shows in float32 beside the kept spheres'.

Computed in ``dtype`` throughout (float32 for the reference, bfloat16 for
the control), with TF32 off for matmul and cudnn while it runs; the
results come back in float32.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch import Tensor

CLIP = 30.0
# Lanes of a block of the dense pass: rays x spheres.
DENSE_LANES = 1 << 26
_ZENITH = (128.0 / 255.0, 178.0 / 255.0, 1.0)


@contextlib.contextmanager
def _no_tf32():
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def _sig(x: Tensor) -> Tensor:
    return 1.0 / (1.0 + torch.exp(torch.clamp(-x, -CLIP, CLIP)))


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return torch.sum(a * b, dim=-1)


def _sky(v: Tensor) -> Tensor:
    u = 0.5 * (v[..., 1:2] + 1.0)
    z = torch.tensor(_ZENITH, dtype=v.dtype, device=v.device)
    return (1.0 - u) + u * z


def sigma_t(o: Tensor, d: Tensor, c: Tensor, r: Tensor, sharpness: float,
            eps: float):
    """sigma (..., K) and t (..., K) of rays o, d (..., 1, 3) against
    spheres c (..., K, 3), r (..., K)."""
    oc = c - o
    a = _dot(d, d)
    t_ca = _dot(oc, d) / torch.clamp(a, min=1e-30)
    q = oc - t_ca[..., None] * d
    perp2 = torch.clamp(_dot(q, q), min=0.0)
    e2 = (eps * r) ** 2
    perp = torch.sqrt(perp2 + e2)
    disc = r * r - perp2
    t = t_ca - (torch.sqrt(torch.clamp(disc, min=0.0) + e2) - eps * r) \
        / torch.sqrt(torch.clamp(a, min=1e-30))
    sigma = _sig(-sharpness * (perp - r) / torch.clamp(r, min=1e-6)) \
        * _sig(sharpness * t)
    return sigma, t


def mirror(o: Tensor, d: Tensor, c: Tensor, t: Tensor) -> Tensor:
    """The mirror direction (..., K, 3) at depth t of rays o, d (..., 1,
    3) off spheres c (..., K, 3)."""
    p = o + t[..., None] * d - c
    n = p / torch.sqrt(torch.clamp(_dot(p, p), min=1e-30))[..., None]
    return d - 2.0 * _dot(d, n)[..., None] * n


def floor(dtype) -> float:
    """sig(-30) in ``dtype``: the least sigma of the model."""
    return float(_sig(torch.tensor(-2 * CLIP, dtype=dtype)))


def kept(o: Tensor, d: Tensor, c: Tensor, r: Tensor, sharpness: float,
         eps: float) -> Tensor:
    """(B, M) int64: each ray's spheres whose sigma is above the floor, in
    ascending id order, padded with -1 (M the most any ray keeps, at least
    1). The dense pass, in blocks of rays, without autograd."""
    f = floor(o.dtype)
    B, N = o.shape[0], c.shape[0]
    step = max(1, DENSE_LANES // max(N, 1))
    rows, cols = [], []
    with torch.no_grad():
        for i in range(0, B, step):
            sigma, _ = sigma_t(o[i:i + step, None], d[i:i + step, None],
                               c[None], r[None], sharpness, eps)
            ri, ci = torch.nonzero(sigma > f, as_tuple=True)
            rows.append(ri + i)
            cols.append(ci)
    rows, cols = torch.cat(rows), torch.cat(cols)
    count = torch.bincount(rows, minlength=B)
    M = max(1, int(count.max())) if B else 1
    start = torch.cumsum(count, 0) - count
    idx = torch.full((B, M), -1, dtype=torch.long, device=o.device)
    idx[rows, torch.arange(rows.numel(), device=o.device) - start[rows]] = cols
    return idx


def image(o: Tensor, d: Tensor, c: Tensor, r: Tensor, albedo: Tensor,
          idx: Tensor, sharpness: float, eps: float,
          clip_as: Tensor | None = None, band: float = 0.0) -> Tensor:
    """(B, 3) soft image of rays o, d (B, 3) over each ray's spheres
    ``idx`` (B, M), -1 for none.

    The clip to [0, 1] passes the gradient of a channel inside it (its
    ends included). Where ``clip_as`` (B, 3) is given, a channel whose
    unclipped value lies within ``band`` of 0 or 1 passes it as
    ``clip_as`` does there: only strictly inside (0, 1). The model's
    gradient jumps at the clip, and a channel that close to it lies on
    either side in two float32 computations of the same model."""
    real = idx >= 0
    safe = torch.clamp(idx, min=0)
    # A unit radius where no sphere is: no sqrt at 0 in the backward.
    rr = torch.where(real, r[safe], torch.ones_like(r[safe]))
    cs = c[safe]
    sigma, t = sigma_t(o[:, None], d[:, None], cs, rr, sharpness, eps)
    shade = albedo[safe] + 0.5 * _sky(mirror(o[:, None], d[:, None], cs, t))
    sigma = torch.where(real, sigma, torch.zeros_like(sigma))
    t = torch.where(real, t, torch.full_like(t, math.inf))
    order = torch.argsort(t, dim=1, stable=True)
    a = torch.gather(sigma * (1.0 - 1e-6), 1, order)
    s = torch.gather(shade, 1, order[..., None].expand(*order.shape, 3))
    through = torch.cumprod(1.0 - a, dim=1)             # T after each
    T = torch.cat([torch.ones_like(through[:, :1]), through[:, :-1]], dim=1)
    img = torch.sum((a * T)[..., None] * s, dim=1) \
        + through[:, -1:] * _sky(d)
    if clip_as is None:
        return torch.clamp(img, 0.0, 1.0)
    u = img.detach()
    near = ((u - 1.0).abs() <= band) | (u.abs() <= band)
    passes = torch.where(near, (clip_as > 0.0) & (clip_as < 1.0),
                         (u >= 0.0) & (u <= 1.0))
    return torch.clamp(u, 0.0, 1.0) \
        + torch.where(passes, img - u, torch.zeros_like(img))


def render(o: Tensor, d: Tensor, centers: Tensor, radii: Tensor,
           albedo: Tensor, sharpness: float, eps: float,
           dtype=torch.float32) -> Tensor:
    """(B, 3) float32 soft image of rays o, d (B, 3), in ``dtype``."""
    with _no_tf32(), torch.no_grad():
        o, d, c, r, alb = (x.to(dtype) for x in (o, d, centers, radii,
                                                   albedo))
        idx = kept(o, d, c, r, sharpness, eps)
        return image(o, d, c, r, alb, idx, sharpness, eps).float()


def loss_grad(o: Tensor, d: Tensor, target: Tensor, centers: Tensor,
              radii: Tensor, albedo: Tensor, sharpness: float, eps: float,
              dtype=torch.float32, clip_as: Tensor | None = None,
              band: float = 0.0):
    """(loss, image (B, 3), (d loss / d centres, / d radii, / d albedo)),
    all float32, the loss the mean of (image - target)^2; in ``dtype``.
    ``clip_as`` and ``band`` as :func:`image` takes them."""
    with _no_tf32():
        o, d, t, c, r, alb = (x.detach().to(dtype) for x in (
            o, d, target, centers, radii, albedo))
        if clip_as is not None:
            clip_as = clip_as.detach().to(dtype)
        idx = kept(o, d, c, r, sharpness, eps)
        leaves = [x.requires_grad_(True) for x in (c, r, alb)]
        with torch.enable_grad():
            img = image(o, d, *leaves, idx, sharpness, eps, clip_as, band)
            loss = torch.mean((img - t) ** 2)
            loss.backward()
        return (loss.detach().float(), img.detach().float(),
                tuple(x.grad.float() for x in leaves))
