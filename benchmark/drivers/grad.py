"""Inverse-rendering evaluations: a soft image's loss and its gradients.

Each request is one checked soft evaluation of the port,
``diff.sparse.soft_loss_grad_sparse``, over a batch of origin rays from a
pool drawn in set-up and cycled: the mean squared difference between the
soft image of the evaluated scene and the batch's target, the image, and
the gradients with respect to the centres, radii and albedo. The evaluated
scene is the configuration's spheres moved and lifted as ``cli fit``
moves them (``perturbation``), drawn from the seed; its cull tables come
from a tree over radii inflated by ``soft_radius_scale`` at the
configuration's widths. A batch's target is the soft image of the
unmoved scene, from the plain reference, made in set-up. A request's work
is one evaluation.

The check takes a sample of the window's evaluations, drawn from the
seed, and computes each again with the plain reference
(``reference/soft.py``): every ray against every sphere, without a tree.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from benchmark import inputs
from benchmark.drivers import common
from benchmark.reference import soft as reference
from benchmark.timing import sync

PERTURB_STREAM = 1 << 21
# Within this of the clip's ends a channel of a sound image may lie on
# either side of the clip in the reference: the limit of image_max_abs.
CLIP_BAND = 2e-3


def setup(cfg: dict, tr: dict, seed: int, device: torch.device):
    from tracer_torch.bvh.builder import build_bvh
    from tracer_torch.diff.soft import SoftParams
    from tracer_torch.diff.sparse import (soft_loss_grad_sparse,
                                          soft_radius_scale)
    from tracer_torch.kernels.leafcull import build_cull_tables
    st = SimpleNamespace(cfg=cfg, tr=tr, seed=seed, device=device,
                         evaluate=soft_loss_grad_sparse)
    st.params = SoftParams(**cfg["soft"])
    centers, radii, albedo = inputs.spheres(cfg, seed, device)
    pert = cfg["perturbation"]
    g = inputs.generator(seed, PERTURB_STREAM, device)
    noise = torch.randn(centers.shape, generator=g, device=device)
    st.centers = centers + float(pert["center_sigma_radii"]) * noise \
        * torch.mean(radii)
    st.radii = radii
    lo, hi = pert["albedo_clip"]
    st.albedo = torch.clamp(albedo + float(pert["albedo_lift"]), float(lo),
                            float(hi))
    st.scene = common.scene(st)
    b = cfg["bvh"]
    if b["builder"] != "native_sah":
        raise ValueError("the grad driver builds the native SAH tree")
    scale = soft_radius_scale(st.params, widths=float(b["inflate_widths"]))
    st.tables = build_cull_tables(st.scene, build_bvh(
        st.centers, st.radii * scale, leaf_size=int(b["leaf_size"]),
        backend="native", device=device))
    if st.tables.num_chunks != 1:
        raise ValueError("the soft evaluation wants single-chunk tables")
    n = int(tr["rays"])
    st.pool = [inputs.directions(n, seed, 1 + k, device)
               for k in range(int(tr["pool"]))]
    st.origin = torch.tensor(tr["origin"], dtype=torch.float32,
                             device=device).expand(n, 3).contiguous()
    st.targets = [reference.render(
        st.origin, d, centers, radii, albedo, st.params.edge_sharpness,
        st.params.smooth_eps) for d in st.pool]
    return st


def _evaluate(st, k: int):
    from tracer_torch.core.types import Ray
    tr = st.tr
    return st.evaluate(
        st.scene, Ray(origin=st.origin, direction=st.pool[k]),
        st.targets[k], st.tables, st.params,
        max_groups=int(tr["max_groups"]), max_leaves=int(tr["max_leaves"]),
        subpacket=int(tr["subpacket"]), cell_bits=int(tr["cell_bits"]),
        block_bytes=int(tr["block_bytes"]))


def warmup(st) -> None:
    for n in range(int(st.tr["warmup_requests"])):
        _evaluate(st, n % len(st.pool))
    sync(st.device)


def request(st, spans):
    pool = len(st.pool)

    def run(n: int):
        k = n % pool
        spans.mark("soft")
        loss, img, grads, _ = _evaluate(st, k)
        spans.close()
        sync(st.device)
        spans.read()
        return 1, False, (k, loss, img, grads)
    return run


def release(st, kept):
    """The kept evaluations as they are, (pool index, loss, image,
    gradients); the tables and the port's scene are dropped."""
    del st.tables, st.scene
    common.free(st.device)
    return kept


def _finite(x: float) -> float:
    return x if x == x else float("inf")


def check(st, kept, control=None) -> dict:
    """image_max_abs: the largest |image - reference| over the kept
    evaluations' rays and channels; grad_rel_l2: the largest relative L2
    error |g - g_ref| / |g_ref| of the three gradients (centres, radii,
    albedo); loss_rel_err, beside them: |loss - loss_ref| / loss_ref.
    A NaN reads as infinity.

    The model's gradient jumps where a channel meets the clip to [0, 1],
    and two sound float32 images (within image_max_abs's limit of each
    other) may put a channel that close on either side: one pixel then
    moved a gradient by up to 0.11 of its norm at 100k spheres. So the
    reference takes the checked image's side of the clip for channels
    within CLIP_BAND of its ends, its own elsewhere."""
    s, eps = st.params.edge_sharpness, st.params.smooth_eps
    img_err = grad_err = loss_err = 0.0
    for k, loss, img, grads in kept:
        args = (st.origin, st.pool[k], st.targets[k], st.centers, st.radii,
                st.albedo, s, eps)
        if control is not None:
            loss, img, grads = reference.loss_grad(
                *args, dtype=common.dtype(control))
        r_loss, r_img, r_grads = reference.loss_grad(
            *args, clip_as=img, band=CLIP_BAND)
        img_err = max(img_err, _finite(float(
            (img.float() - r_img).abs().max())))
        for g, r in zip(grads, r_grads):
            grad_err = max(grad_err, _finite(float(
                torch.linalg.vector_norm(g.float() - r)
                / torch.linalg.vector_norm(r))))
        loss_err = max(loss_err, _finite(
            abs(float(loss) - float(r_loss)) / float(r_loss)))
    return {"image_max_abs": img_err, "grad_rel_l2": grad_err,
            "loss_rel_err": loss_err, "checked_evaluations": len(kept)}
