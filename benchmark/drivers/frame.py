"""Path-traced frames: the reference's interactive renderer.

Each request is one frame: its bounce noise drawn on the device from (seed,
frame number), then ``integrator.wavefront.render`` with the closest hit
that ``cli.make_nearest`` builds for the traffic's ``--impl`` and the
configuration's render leaf size (on the card, ``auto`` is the leaf walk
behind its escalating driver), with wavefront compaction as the traffic
says. The camera flies ``fly_speed`` units a frame along its forward axis
and starts over after ``path_frames`` frames, so that every frame of any
window lies on one path inside the scene. A request's work is one frame.

The check takes a sample of the window's frames and of their pixels, both
drawn from the seed, and traces each sampled pixel again with the plain
reference, from the same pose and the same noise.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from benchmark import inputs
from benchmark.drivers import common
from benchmark.timing import sync
from benchmark.reference.path import camera_rays, radiance

WARMUP_STREAM = 1 << 20


def _args(st):
    from tracer_torch import cli
    tr = st.tr
    a = ["render", "--impl", tr["impl"], "--mode", tr["mode"],
         "--leaf-size", str(st.cfg["bvh"]["render_leaf_size"]),
         "--width", str(tr["width"]), "--height", str(tr["height"]),
         "--depth", str(tr["depth"]), "--device", st.device.type,
         "--compact" if tr["compact"] else "--no-compact"]
    return cli.build_parser().parse_args(a)


def setup(cfg: dict, tr: dict, seed: int, device: torch.device):
    from tracer_torch import cli
    from tracer_torch.config import TracerConfig
    if tr["mode"] != "path":
        raise ValueError("the frame driver renders path-traced frames")
    st = SimpleNamespace(cfg=cfg, tr=tr, seed=seed, device=device)
    st.centers, st.radii, st.albedo = inputs.spheres(cfg, seed, device)
    st.scene = common.scene(st)
    st.poses = torch.as_tensor(inputs.fly_positions(
        tr["camera"], float(tr["fly_speed"]), int(tr["path_frames"])),
        device=device)
    st.tables = {}
    st.nearest, st.info = cli.make_nearest(_args(st), st.scene, _camera(st, 0),
                                           device, {}, st.tables)
    st.config = TracerConfig(width=int(tr["width"]),
                             height=int(tr["height"]),
                             max_depth=int(tr["depth"]))
    return st


def _camera(st, pose: int):
    from tracer_torch.scene.camera import Camera
    cam = st.tr["camera"]

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=st.device)

    return Camera(position=st.poses[pose], yaw=f32(cam["yaw"]),
                  pitch=f32(cam["pitch"]), fov=f32(cam["fov"]))


def _noise(st, stream: int):
    tr = st.tr
    g = inputs.generator(st.seed, stream, st.device)
    return torch.randn((int(tr["depth"]) - 1, int(tr["height"]),
                        int(tr["width"]), 3), generator=g, device=st.device)


def _frame(st, pose: int, noise):
    from tracer_torch.integrator import wavefront
    return wavefront.render(st.scene, _camera(st, pose), None, st.nearest,
                            st.config, noise=noise,
                            compact=bool(st.tr["compact"]))


def warmup(st) -> None:
    frames = int(st.tr["path_frames"])
    w = int(st.tr["warmup_requests"])
    for n in range(w):
        _frame(st, n * frames // max(w, 1),
               _noise(st, WARMUP_STREAM + n))
    sync(st.device)


def request(st, spans):
    frames = int(st.tr["path_frames"])

    def run(n: int):
        pose = n % frames
        spans.mark("frame")
        noise = _noise(st, 100 + n)
        img = _frame(st, pose, noise)
        spans.close()
        sync(st.device)
        spans.read()
        return 1, False, (pose, noise, img)
    return run


def release(st, kept):
    """Each kept frame as (pose, sampled pixels, their noise (depth - 1,
    n, 3), their colours); the trees and tables are dropped."""
    tr = st.tr
    w, h = int(tr["width"]), int(tr["height"])
    rng = inputs.numpy_rng(st.seed, 7)
    n_check = min(int(tr["check_pixels"]), w * h)
    out = []
    for pose, noise, img in kept:
        px = torch.as_tensor(rng.choice(w * h, n_check, replace=False),
                             device=st.device)
        out.append((pose, px, noise.reshape(noise.shape[0], -1, 3)[:, px],
                    img.reshape(-1, 3)[px].float()))
    del st.nearest, st.tables, st.scene
    common.free(st.device)
    return out


def check(st, kept, control=None) -> dict:
    """pixel_mismatch_share: sampled pixels whose colour differs from the
    reference's by more than 1e-3 in a channel; pixel_err_mean: the mean
    absolute difference over sampled channels."""
    tr = st.tr
    cam = tr["camera"]
    mism, n, err = 0, 0, 0.0
    for pose, px, noise, img in kept:
        dt = torch.float32 if control is None else common.dtype(control)
        o, d = camera_rays(st.poses[pose], cam["yaw"], cam["pitch"],
                           cam["fov"], int(tr["width"]), int(tr["height"]),
                           px, torch.float32)
        ref = radiance(o, d, noise, st.centers, st.radii, st.albedo,
                       int(tr["depth"]))
        if control is not None:
            o, d = camera_rays(st.poses[pose], cam["yaw"], cam["pitch"],
                               cam["fov"], int(tr["width"]),
                               int(tr["height"]), px, dt)
            img = radiance(o, d, noise, st.centers, st.radii, st.albedo,
                           int(tr["depth"]), dtype=dt)
        diff = (img - ref).abs()
        mism += int((~(diff.amax(1) <= 1e-3)).sum())
        n += px.numel()
        err += float(diff.sum())
    return {"pixel_mismatch_share": mism / max(n, 1),
            "pixel_err_mean": err / max(3 * n, 1), "checked_pixels": n}

