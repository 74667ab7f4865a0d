"""Command line: ``python -m tracer_torch.cli render ...``.

PyTorch counterpart of the ``render`` command of ``tracer/cli.py``: renders
frames of a sphere scene (path tracing, or primary plus shadow rays) and
writes the accumulated image as ``.npy`` and PNG, plus optional frame-time
metrics. Runs on the CUDA device unless ``--device cpu`` is given; without
a card it refuses rather than drop to the CPU.

Differences from the JAX command:
  * every closest-hit and shadow query of the tile-cull and leaf-walk
    intersectors goes through the budget-doubling drivers, so an
    overflowing subpacket is re-run with larger budgets instead of losing
    hits; the run prints how often each query escalated;
  * frames are timed with CUDA events on the card (the first is dropped);
  * PNG is written with zlib and struct (no imaging library);
  * ``--profile``, ``--checkpoint`` and ``--resume`` are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import struct
import sys
import time
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

import numpy as np
import torch

DENSE_MAX_SPHERES = 4000   # the dense sweep beats the hierarchy up to here


def write_png(path, rgb: np.ndarray) -> None:
    """(H, W, 3) uint8 -> 8-bit RGB PNG, filter 0 on every row."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def to_uint8(img) -> np.ndarray:
    """[0, 1] float image -> uint8, truncating like the JAX command."""
    a = img.detach().cpu().numpy() if isinstance(img, torch.Tensor) else img
    return (np.asarray(a) * 255).astype(np.uint8)


@dataclass
class Session:
    """Everything one render run needs: scene, camera, config, the frame
    function ``frame(camera, noise) -> (H, W, 3)``, the closest-hit
    factory ``nearest(scene) -> (rays -> HitRecord)``, the intersector info
    for the metrics, the query counters (calls and escalations), and the
    tables the intersector built (by name)."""

    args: argparse.Namespace
    device: torch.device
    scene: object
    camera: object
    config: object
    frame: Callable
    nearest: Callable
    info: dict
    counts: dict = field(default_factory=dict)
    tables: dict = field(default_factory=dict)


def resolve_device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("tracer_torch render: no CUDA device; pass "
                         "--device cpu to render on the CPU")
    return dev


def make_scene_camera(args, device):
    from tracer_torch.scene.camera import Camera
    from tracer_torch.scene.scene import benchmark_scene, random_scene
    gen = torch.Generator().manual_seed(args.seed)
    if args.scene == "interactive":
        scene = random_scene(gen, args.spheres, device=device)
    else:
        scene = benchmark_scene(gen, args.spheres,
                                world_size=args.world_size, device=device)
    cam = Camera.default(device)

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    if args.camera_pos:
        cam = cam.replace(position=f32(
            [float(x) for x in args.camera_pos.split(",")]))
    if args.yaw is not None:
        cam = cam.replace(yaw=f32(args.yaw))
    if args.pitch is not None:
        cam = cam.replace(pitch=f32(args.pitch))
    return scene, cam


def _counted(counts: dict, name: str, query):
    """Wrap a checked query returning (result, escalations) so each call
    adds to ``counts[name + "_calls"]`` and ``counts[name +
    "_escalations"]``."""
    counts.setdefault(f"{name}_calls", 0)
    counts.setdefault(f"{name}_escalations", 0)

    def run(*a):
        out, esc = query(*a)
        counts[f"{name}_calls"] += 1
        counts[f"{name}_escalations"] += esc
        return out
    return run


def _build(scene, cam, leaf_size: int):
    from tracer_torch.bvh.builder import build_bvh
    t0 = time.perf_counter()
    bvh = build_bvh(scene.centers, scene.radii, leaf_size=leaf_size,
                    near_point=tuple(cam.position.tolist()),
                    device=scene.centers.device)
    return bvh, (time.perf_counter() - t0) * 1e3


def make_nearest(args, scene, cam, device, counts: dict,
                 tables: dict | None = None):
    """--impl -> (nearest_hit_for(scene), info). ``auto`` takes the dense
    sweep up to 4000 spheres, then the leaf walk on the card and the
    per-ray traversal on the CPU; ``brute`` is the reference's bvh == NULL
    path (src/renderer.c:29-44). What the intersector builds (tree,
    packed tables, leaf table, prim tiles, cone tables) lands in
    ``tables`` when given (bvh, packed, leaf_table, cone)."""
    from tracer_torch.intersect.brute import (nearest_hit_brute,
                                              nearest_hit_brute_fast)
    tables = {} if tables is None else tables
    impl = args.impl
    n = int(scene.centers.shape[0])
    if impl == "auto":
        if not args.bvh:
            impl = "brute"
        elif n <= DENSE_MAX_SPHERES:
            impl = "dense"
        else:
            impl = "leafcull" if device.type == "cuda" else "traverse"
    if not args.bvh or impl == "brute":
        return (lambda s: (lambda r: nearest_hit_brute(r, s))), {
            "impl": "brute", "bvh_build_ms": 0.0}
    if impl == "dense":
        return (lambda s: (lambda r: nearest_hit_brute_fast(r, s))), {
            "impl": "dense", "bvh_build_ms": 0.0}

    bvh, build_ms = _build(scene, cam, args.leaf_size)
    tables["bvh"] = bvh
    print(f"BVH built in {build_ms:.1f} ms ({bvh.num_nodes} nodes)")
    info = {"impl": impl, "bvh_build_ms": build_ms,
            "bvh_nodes": bvh.num_nodes}
    if impl == "traverse":
        from tracer_torch.intersect.traverse import nearest_hit_bvh
        return (lambda s: (lambda r: nearest_hit_bvh(r, s, bvh))), info
    if impl == "pallas":
        from tracer_torch.kernels.traverse import (nearest_hit_bvh_packets,
                                                   pack_bvh)
        packed = tables["packed"] = pack_bvh(scene, bvh)
        return (lambda s: (lambda r: nearest_hit_bvh_packets(
            r, s, packed))), info
    if impl == "tilecull":
        from tracer_torch.intersect.cull import build_leaf_table
        from tracer_torch.kernels.tilecull import nearest_hit_tilecull_checked
        from tracer_torch.kernels.traverse import pack_bvh
        packed = tables["packed"] = pack_bvh(scene, bvh)
        table = tables["leaf_table"] = build_leaf_table(bvh)
        k = min(args.max_candidates, table.num_tiles)
        query = _counted(counts, "closest", lambda r, s: (
            nearest_hit_tilecull_checked(r, s, packed, table,
                                         max_candidates=k)))
        return (lambda s: (lambda r: query(r, s))), info
    if impl == "leafcull":
        from tracer_torch.kernels.conecull import build_cone_tables
        from tracer_torch.kernels.leafcull import nearest_hit_leafcull_checked
        ls = args.leaf_size
        if ls % 2 or 128 % ls or ls > 32:      # the JAX command's rebuild
            bvh, _ = _build(scene, cam, 32)
        cone = tables["cone"] = build_cone_tables(scene, bvh)
        query = _counted(counts, "closest", lambda r, s: (
            nearest_hit_leafcull_checked(r, s, cone)))
        return (lambda s: (lambda r: query(r, s))), info
    raise SystemExit(f"unknown --impl {impl}")


def make_occluded(args, scene, device, counts: dict):
    """Shadow query for --mode direct: the any-hit leaf walk on the card
    above 4000 spheres (over a leaf-size-32 tree, as the JAX command
    builds), else the dense oracle."""
    from tracer_torch.intersect.brute import any_hit_brute
    n = int(scene.centers.shape[0])
    if device.type == "cuda" and args.bvh and n > DENSE_MAX_SPHERES:
        from tracer_torch.bvh.builder import build_bvh
        from tracer_torch.kernels.conecull import build_cone_tables
        from tracer_torch.kernels.leafcull import occluded_leafcull_checked
        bvh = build_bvh(scene.centers, scene.radii, leaf_size=32,
                        device=device)
        tables = build_cone_tables(scene, bvh)
        query = _counted(counts, "shadow", lambda r, tmax: (
            occluded_leafcull_checked(r, tables, tmax)))
        return lambda s: query
    return lambda s: (lambda r, tmax: any_hit_brute(r, s, tmax))


def prepare(args) -> Session:
    """Scene, camera, intersectors and the frame function of a render run."""
    from tracer_torch.config import TracerConfig
    from tracer_torch.integrator.wavefront import render, render_direct
    device = resolve_device(args.device)
    cfg = TracerConfig(width=args.width, height=args.height,
                       max_depth=args.depth)
    scene, cam = make_scene_camera(args, device)
    counts: dict = {}
    tables: dict = {}
    nearest, info = make_nearest(args, scene, cam, device, counts, tables)
    if args.mode == "direct":
        light = torch.tensor([float(x) for x in args.light.split(",")],
                             dtype=torch.float32, device=device)
        occluded = make_occluded(args, scene, device, counts)

        def frame(c, noise):
            return render_direct(scene, c, light, nearest, occluded, cfg,
                                 light_intensity=args.light_intensity,
                                 compact=args.compact)
    else:
        def frame(c, noise):
            return render(scene, c, None, nearest, cfg, noise=noise,
                          compact=args.compact)
    return Session(args=args, device=device, scene=scene, camera=cam,
                   config=cfg, frame=frame, nearest=nearest, info=info,
                   counts=counts, tables=tables)


class _Clock:
    """Frame timer: CUDA events on the card, the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self):
        if self.cuda:
            self.t0 = torch.cuda.Event(enable_timing=True)
            self.t0.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> float:
        """Seconds since start(), after the frame's work has finished."""
        if self.cuda:
            t1 = torch.cuda.Event(enable_timing=True)
            t1.record()
            t1.synchronize()
            return self.t0.elapsed_time(t1) / 1e3
        return time.perf_counter() - self.t0


def render_frames(session: Session, noise_for: Callable[[int], object]):
    """Render ``--frames`` frames; ``noise_for(i)`` gives frame i's bounce
    noise. The camera flies ``--fly-speed`` units along its forward axis
    per frame after the first (the scripted analog of WASD,
    src/main.c:288-315); accumulation resets on motion and averages while
    still (src/main.c:241-273). Returns (Accumulator, seconds per frame)."""
    from tracer_torch.integrator.wavefront import Accumulator
    args, cfg = session.args, session.config
    acc = Accumulator.zero(cfg.height, cfg.width, session.device)
    cam = session.camera
    clock = _Clock(session.device)
    times = []
    for i in range(args.frames):
        noise = noise_for(i)
        moving = args.fly_speed != 0.0 and i > 0
        if moving:
            f, _, _ = cam.basis()
            cam = cam.replace(position=cam.position + args.fly_speed * f)
        clock.start()
        img = session.frame(cam, noise)
        times.append(clock.stop())
        acc = acc.reset_to(img) if (moving or i == 0) else acc.add(img)
    return acc, times


def metrics(session: Session, times) -> dict:
    """The JAX command's metrics record, by the same formulas (the first
    frame dropped when there are more), plus mode and escalation counts;
    ``platform`` names the card."""
    args, cfg = session.args, session.config
    times = times[1:] or times
    mean_t = float(np.mean(times))
    rays_per_frame = cfg.width * cfg.height * cfg.max_depth
    platform = (torch.cuda.get_device_name(session.device)
                if session.device.type == "cuda" else "cpu")
    return {
        "width": cfg.width, "height": cfg.height,
        "max_depth": cfg.max_depth, "spheres": args.spheres,
        "frames": args.frames, "compact": bool(args.compact),
        "mean_frame_s": round(mean_t, 5),
        "fps": round(1.0 / mean_t, 2),
        "mrays_per_s": round(rays_per_frame / mean_t / 1e6, 2),
        "platform": platform,
        **session.info,
        "mode": args.mode,
        "escalations": dict(session.counts),
    }


def cmd_render(args) -> int:
    from tracer_torch.integrator.wavefront import bounce_noise
    session = prepare(args)
    cfg = session.config
    gen = torch.Generator(device=session.device).manual_seed(args.seed + 1)
    acc, times = render_frames(session, lambda i: bounce_noise(
        gen, (cfg.height, cfg.width), cfg.max_depth, session.device))
    img = to_uint8(acc.mean)
    out = Path(args.out)
    np.save(out.with_suffix(".npy"), acc.mean.cpu().numpy())
    write_png(out, img)
    print(f"wrote {out} and {out.with_suffix('.npy')}")
    rec = metrics(session, times)
    print(f"frames: {args.frames}, mean frame time {rec['mean_frame_s']:.4f}"
          f" s ({rec['fps']:.2f} FPS)")
    print("escalations: " + (", ".join(
        f"{k} {v}" for k, v in sorted(session.counts.items()))
        or "none (this intersector has no candidate budget)"))
    if args.metrics:
        with open(args.metrics, "w") as f:
            json.dump(rec, f, indent=2)
        print(f"wrote {args.metrics}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tracer_torch",
                                description="SAH-BVH ray tracer on PyTorch "
                                            "and CUDA")
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("render", help="render frames to PNG and .npy")
    sp.add_argument("--width", type=int, default=800)    # constants.h:7
    sp.add_argument("--height", type=int, default=600)   # constants.h:8
    sp.add_argument("--depth", type=int, default=5)      # main.c:19
    sp.add_argument("--spheres", type=int, default=20)   # main.c:18
    sp.add_argument("--scene", choices=["interactive", "benchmark"],
                    default="interactive")
    sp.add_argument("--world-size", type=float, default=1000.0)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--camera-pos", default=None,
                    help="x,y,z (default 0,4,50; src/main.c:203-211)")
    sp.add_argument("--yaw", type=float, default=None)
    sp.add_argument("--pitch", type=float, default=None)
    sp.add_argument("--frames", type=int, default=1)
    sp.add_argument("--fly-speed", type=float, default=0.0,
                    help="forward units/frame (scripted fly-through)")
    sp.add_argument("--bvh", action=argparse.BooleanOptionalAction,
                    default=True, help="the 'B' toggle (src/main.c:317-320)")
    sp.add_argument("--impl", default="auto",
                    choices=["auto", "brute", "dense", "traverse", "pallas",
                             "tilecull", "leafcull"],
                    help="intersector (auto: the leaf walk on the card)")
    sp.add_argument("--leaf-size", type=int, default=16)
    sp.add_argument("--max-candidates", type=int, default=128,
                    help="tilecull per-subpacket tile budget (doubled on "
                         "overflow)")
    sp.add_argument("--compact", action=argparse.BooleanOptionalAction,
                    default=False, help="wavefront compaction between bounces")
    sp.add_argument("--mode", choices=["path", "direct"], default="path",
                    help="path = reference bounce integrator; direct = "
                         "primary + shadow rays (BASELINE config 3)")
    sp.add_argument("--light", default="0,200,0",
                    help="point light position x,y,z (direct mode)")
    sp.add_argument("--light-intensity", type=float, default=1.0)
    sp.add_argument("--metrics", default=None,
                    help="write frame-time/FPS JSON here")
    sp.add_argument("--out", default="render.png")
    sp.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    sp.set_defaults(fn=cmd_render)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
