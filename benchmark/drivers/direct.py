"""Direct-lit frames: primary plus shadow rays toward a point light.

Each request is one frame of ``integrator.wavefront.render_direct``: the
closest hit that ``cli.make_nearest`` builds for the traffic's ``--impl``
and the configuration's render leaf size, then one shadow (any-hit) query
over the frame's hit points from ``cli.make_occluded`` (on the card,
``auto`` is the any-hit leaf walk over a leaf-32 tree behind its
escalating driver), both built from the parsed arguments of ``render
--mode direct``, with the configuration's light passed through ``--light``
and ``--light-intensity`` and its ambient term to ``render_direct``. The
camera flies as in the path-traced frames (``drivers/frame.py``). A
request's work is one frame.

The check takes a sample of the window's frames and of their pixels, both
drawn from the seed, and shades each sampled pixel again with the plain
reference (``reference/direct.py``), from the same pose.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from benchmark import inputs
from benchmark.drivers import common
from benchmark.drivers.frame import _camera
from benchmark.reference.direct import shade
from benchmark.reference.path import camera_rays
from benchmark.timing import sync

SHADOW_LEAF_SIZE = 32   # the tree that cli.make_occluded builds


def _args(st):
    from tracer_torch import cli
    tr, light = st.tr, st.cfg["light"]
    a = ["render", "--mode", "direct", "--impl", tr["impl"],
         "--leaf-size", str(st.cfg["bvh"]["render_leaf_size"]),
         "--light", ",".join(str(float(x)) for x in light["position"]),
         "--light-intensity", str(float(light["intensity"])),
         "--width", str(tr["width"]), "--height", str(tr["height"]),
         "--device", st.device.type,
         "--compact" if tr["compact"] else "--no-compact"]
    return cli.build_parser().parse_args(a)


def setup(cfg: dict, tr: dict, seed: int, device: torch.device):
    from tracer_torch import cli
    from tracer_torch.config import TracerConfig
    if int(cfg["bvh"]["shadow_leaf_size"]) != SHADOW_LEAF_SIZE:
        raise ValueError(f"the shadow tree's leaf size is {SHADOW_LEAF_SIZE}")
    st = SimpleNamespace(cfg=cfg, tr=tr, seed=seed, device=device)
    st.centers, st.radii, st.albedo = inputs.spheres(cfg, seed, device)
    st.scene = common.scene(st)
    st.poses = torch.as_tensor(inputs.fly_positions(
        tr["camera"], float(tr["fly_speed"]), int(tr["path_frames"])),
        device=device)
    st.args = _args(st)
    st.light = torch.tensor([float(x) for x in st.args.light.split(",")],
                            dtype=torch.float32, device=device)
    st.counts, st.tables = {}, {}
    st.nearest, _ = cli.make_nearest(st.args, st.scene, _camera(st, 0),
                                     device, st.counts, st.tables)
    st.occluded = cli.make_occluded(st.args, st.scene, device, st.counts)
    st.config = TracerConfig(width=int(tr["width"]),
                             height=int(tr["height"]))
    return st


def _frame(st, pose: int):
    from tracer_torch.integrator import wavefront
    return wavefront.render_direct(
        st.scene, _camera(st, pose), st.light, st.nearest, st.occluded,
        st.config, light_intensity=st.args.light_intensity,
        ambient=float(st.cfg["light"]["ambient"]), compact=st.args.compact)


def warmup(st) -> None:
    frames = int(st.tr["path_frames"])
    w = int(st.tr["warmup_requests"])
    for n in range(w):
        _frame(st, n * frames // max(w, 1))
    sync(st.device)


def request(st, spans):
    frames = int(st.tr["path_frames"])

    def run(n: int):
        pose = n % frames
        spans.mark("frame")
        img = _frame(st, pose)
        spans.close()
        sync(st.device)
        spans.read()
        return 1, False, (pose, img)
    return run


def release(st, kept):
    """Each kept frame as (pose, sampled pixels, their colours); the trees
    and tables are dropped."""
    tr = st.tr
    w, h = int(tr["width"]), int(tr["height"])
    rng = inputs.numpy_rng(st.seed, 7)
    n_check = min(int(tr["check_pixels"]), w * h)
    out = []
    for pose, img in kept:
        px = torch.as_tensor(rng.choice(w * h, n_check, replace=False),
                             device=st.device)
        out.append((pose, px, img.reshape(-1, 3)[px].float()))
    del st.nearest, st.occluded, st.tables, st.scene
    common.free(st.device)
    return out


def check(st, kept, control=None) -> dict:
    """pixel_mismatch_share: sampled pixels whose colour differs from the
    reference's by more than 1e-3 in a channel; pixel_err_mean: the mean
    absolute difference over sampled channels."""
    tr, cam, light = st.tr, st.tr["camera"], st.cfg["light"]
    dt = torch.float32 if control is None else common.dtype(control)

    def reference(pose, px, dtype):
        o, d = camera_rays(st.poses[pose], cam["yaw"], cam["pitch"],
                           cam["fov"], int(tr["width"]), int(tr["height"]),
                           px, dtype)
        return shade(o, d, st.centers, st.radii, st.albedo,
                     light["position"], float(light["intensity"]),
                     float(light["ambient"]), dtype=dtype)

    mism, n, err = 0, 0, 0.0
    for pose, px, img in kept:
        ref = reference(pose, px, torch.float32)
        if control is not None:
            img = reference(pose, px, dt)
        diff = (img - ref).abs()
        mism += int((~(diff.amax(1) <= 1e-3)).sum())
        n += px.numel()
        err += float(diff.sum())
    return {"pixel_mismatch_share": mism / max(n, 1),
            "pixel_err_mean": err / max(3 * n, 1), "checked_pixels": n}
