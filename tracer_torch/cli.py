"""Command line: ``python -m tracer_torch.cli render|bench|fit|viz ...``.

PyTorch counterpart of ``tracer/cli.py``. ``render`` renders frames of a
sphere scene (path tracing, or primary plus shadow rays) and writes the
accumulated image as ``.npy`` and PNG, plus optional frame-time metrics,
an accumulation checkpoint after each frame (``--checkpoint``, continued by
``--resume``) and a ``torch.profiler`` trace (``--profile DIR``). ``bench``
is the BVH-against-brute-force sweep (``bench/harness.py``): it writes
benchmark_data.txt, benchmark_results.json and benchmark_results.png into
the working directory and prints the complexity fits. ``fit`` is the
inverse-rendering demo: it writes fit_target.png, fit_init.png,
fit_final.png and fit_losses.txt into the working directory. ``viz``
prints the tree's statistics and writes a brute-force render with the
tree's boxes drawn over it. All run on the CUDA device unless ``--device
cpu`` is given; without a card they refuse rather than drop to the CPU.
``TRACER_DEBUG=1`` (or 2) runs a command under the sanitizers of
``tracer_torch.debug``.

Differences from the JAX command:
  * every closest-hit and shadow query of the tile-cull and leaf-walk
    intersectors goes through the budget-doubling drivers, so an
    overflowing subpacket is re-run with larger budgets instead of losing
    hits; the run prints how often each query escalated;
  * frames are timed with CUDA events on the card (the first is dropped);
  * PNG is written with zlib and struct (no imaging library);
  * ``fit`` perturbs the initial centres with a draw from
    ``torch.Generator().manual_seed(seed + 7)``: the same distribution as
    the JAX command's ``jax.random`` draw, not the same numbers; it prints
    the mean step time (CUDA events, the first step dropped) on its loss
    line;
  * a render checkpoint holds the accumulator and the frame noise
    generator's ``torch.Generator`` state, so it is the port's own (the
    JAX command's holds a ``jax.random`` key); on ``--resume`` the camera
    stands where a straight run has it at that frame (moved once per
    frame after the first), where the JAX command restarts the fly-through
    from the initial position;
  * ``bench`` takes ``--seed`` and ``--device``; its scenes and plot are
    described in ``bench/harness.py``;
  * ``viz`` draws its bounce noise from
    ``torch.Generator(device).manual_seed(1)``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import struct
import sys
import time
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from tracer_torch import trace

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
    for the metrics, the query counters (calls and escalations, tallied
    by ``trace.checked``), and the tables the intersector built (by
    name)."""

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
        raise SystemExit("tracer_torch: no CUDA device; pass --device cpu "
                         "to run on the CPU")
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
    ``tables`` when given (bvh, packed, leaf_table, cone). A checked query
    (tile cull, leaf walk) tallies its calls and escalations into
    ``counts`` (``trace.tallied``)."""
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
        query = trace.tallied(counts, lambda r, s: (
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
        query = trace.tallied(counts, lambda r, s: (
            nearest_hit_leafcull_checked(r, s, cone)))
        return (lambda s: (lambda r: query(r, s))), info
    raise SystemExit(f"unknown --impl {impl}")


def make_occluded(args, scene, device, counts: dict):
    """Shadow query for --mode direct: the any-hit leaf walk (over a
    leaf-size-32 tree, as the JAX command builds), checked, its calls and
    escalations tallied into ``counts``; else the dense oracle. ``--impl
    leafcull`` takes the leaf walk on any device (its plain version on the
    CPU), as :func:`make_nearest` does; every other ``--impl`` takes it on
    the card above 4000 spheres. Without ``--bvh`` the oracle."""
    from tracer_torch.intersect.brute import any_hit_brute
    n = int(scene.centers.shape[0])
    walk = args.impl == "leafcull" or (device.type == "cuda"
                                       and n > DENSE_MAX_SPHERES)
    if args.bvh and walk:
        from tracer_torch.bvh.builder import build_bvh
        from tracer_torch.kernels.conecull import build_cone_tables
        from tracer_torch.kernels.leafcull import occluded_leafcull_checked
        bvh = build_bvh(scene.centers, scene.radii, leaf_size=32,
                        device=device)
        tables = build_cone_tables(scene, bvh)
        query = trace.tallied(counts, lambda r, tmax: (
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


def _fly(cam, speed: float):
    """The camera moved ``speed`` units along its forward axis."""
    f, _, _ = cam.basis()
    return cam.replace(position=cam.position + speed * f)


def render_frames(session: Session, noise_for: Callable[[int], object],
                  start: int = 0, acc=None, after_frame=None):
    """Render frames ``start`` to ``--frames`` - 1 into ``acc`` (a zero
    accumulator when None); ``noise_for(i)`` gives frame i's bounce noise
    and ``after_frame(i, acc)``, when given, runs after each frame. The
    camera flies ``--fly-speed`` units along its forward axis per frame
    after the first (the scripted analog of WASD, src/main.c:288-315), so
    at frame i it has moved i times, by the same additions whatever the
    start frame; accumulation resets on motion and averages while still
    (src/main.c:241-273). Returns (Accumulator, seconds per frame)."""
    from tracer_torch.bench.timing import Clock
    from tracer_torch.integrator.wavefront import Accumulator
    args, cfg = session.args, session.config
    if acc is None:
        acc = Accumulator.zero(cfg.height, cfg.width, session.device)
    cam = session.camera
    if args.fly_speed != 0.0:
        for _ in range(1, start):
            cam = _fly(cam, args.fly_speed)
    clock = Clock(session.device)
    times = []
    for i in range(start, args.frames):
        noise = noise_for(i)
        moving = args.fly_speed != 0.0 and i > 0
        if moving:
            cam = _fly(cam, args.fly_speed)
        clock.start()
        img = session.frame(cam, noise)
        times.append(clock.stop())
        acc = acc.reset_to(img) if (moving or i == 0) else acc.add(img)
        if after_frame is not None:
            after_frame(i, acc)
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


@contextlib.contextmanager
def _profiled(directory: str | None, device: torch.device):
    """A torch.profiler context (CPU and, on the card, CUDA activity)
    writing its Chrome trace to ``directory``/trace.json on exit; a
    no-op without ``directory``. The profiler turns ``tracer_torch.trace``
    on, so the trace holds the program's spans beside the kernels, each
    with its id as its first concrete input (the profiler records shapes);
    the trace's store is emptied on entry, so it then holds this run's."""
    if directory is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    trace.reset()
    with profile(activities=acts, record_shapes=True) as prof:
        yield
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path}")


def cmd_render(args) -> int:
    from tracer_torch.checkpoint import load_state, save_state
    from tracer_torch.integrator.wavefront import Accumulator, bounce_noise
    session = prepare(args)
    cfg = session.config
    gen = torch.Generator(device=session.device).manual_seed(args.seed + 1)
    acc = Accumulator.zero(cfg.height, cfg.width, session.device)
    start = 0
    if args.resume and args.checkpoint and os.path.exists(args.checkpoint):
        (total, frames, state), meta = load_state(
            args.checkpoint, (acc.total, torch.tensor(0), gen.get_state()))
        acc = Accumulator(total=total, frames=int(frames))
        gen.set_state(state)
        start = int(meta["frame"])
        print(f"resumed accumulation at frame {start}")

    def checkpoint(i, acc):
        save_state(args.checkpoint, (acc.total, torch.tensor(acc.frames),
                                     gen.get_state()), meta={"frame": i + 1})

    with _profiled(args.profile, session.device):
        acc, times = render_frames(
            session, lambda i: bounce_noise(
                gen, (cfg.height, cfg.width), cfg.max_depth, session.device),
            start, acc, checkpoint if args.checkpoint else None)
    img = to_uint8(acc.mean)
    out = Path(args.out)
    np.save(out.with_suffix(".npy"), acc.mean.cpu().numpy())
    write_png(out, img)
    print(f"wrote {out} and {out.with_suffix('.npy')}")
    if not times:
        print(f"no frame to render: the checkpoint is at frame {start}")
        return 0
    rec = metrics(session, times)
    if args.profile:
        rec["trace"] = trace.summary(trace.records())
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


def fit_problem(args, device):
    """The fit demo's set-up: (config, camera, soft params, target image,
    initial scene). The target is the soft render of the command's scene;
    the initial scene moves every centre by 0.1 x N(0, 1) x the mean
    radius, drawn from ``torch.Generator().manual_seed(seed + 7)``, and
    lifts the albedo by 0.2 (clipped to [0.05, 0.95])."""
    from dataclasses import replace

    from tracer_torch.config import TracerConfig
    from tracer_torch.diff.soft import SoftParams, clip, soft_render
    cfg = TracerConfig(width=args.width, height=args.height,
                       max_depth=args.depth)
    scene, cam = make_scene_camera(args, device)
    soft = SoftParams(edge_sharpness=args.sharpness, tau_depth=args.tau)
    with torch.no_grad():
        target = soft_render(scene, cam, soft, cfg)
        gen = torch.Generator().manual_seed(args.seed + 7)
        noise = torch.randn(scene.centers.shape, generator=gen)
        init = replace(
            scene,
            centers=scene.centers + 0.1 * noise.to(device)
            * torch.mean(scene.radii),
            albedo=clip(scene.albedo + 0.2, 0.05, 0.95))
    return cfg, cam, soft, target, init


def cmd_fit(args) -> int:
    """Inverse-rendering demo (the JAX command's ``fit``): render a target
    with the soft model, perturb the scene, fit it back. Writes
    fit_target.png, fit_init.png, fit_final.png and fit_losses.txt into the
    working directory."""
    from tracer_torch.diff.fit import fit_scene
    from tracer_torch.diff.soft import soft_render
    device = resolve_device(args.device)
    cfg, cam, soft, target, init = fit_problem(args, device)

    def save(img, path):
        write_png(path, to_uint8(img))
        print(f"wrote {path}")

    save(target, "fit_target.png")
    with torch.no_grad():
        save(soft_render(init, cam, soft, cfg), "fit_init.png")
    res = fit_scene(target, init, cam, steps=args.steps, lr=args.lr,
                    soft=soft, config=cfg, checkpoint_path=args.checkpoint,
                    checkpoint_every=args.checkpoint_every,
                    resume=args.resume)
    with torch.no_grad():
        save(soft_render(res.scene, cam, soft, cfg), "fit_final.png")
    # The first step's time holds the warm-up; the mean is over the rest.
    ms = res.step_ms[1:] if res.step_ms.size > 1 else res.step_ms
    step = (f", {float(np.mean(ms)):.3f} ms/step on {device}" if ms.size
            else "")
    print(f"loss: {res.losses[0]:.6f} -> {res.losses[-1]:.6f} "
          f"({args.steps} steps{step})")
    np.savetxt("fit_losses.txt", res.losses)
    return 0


def cmd_bench(args) -> int:
    """The BVH-against-brute-force sweep (``bench/harness.py``); writes
    benchmark_data.txt, benchmark_results.json and benchmark_results.png
    into the working directory and prints the complexity fits."""
    from tracer_torch.bench.harness import (DEFAULT_SIZES, plot_sweep,
                                            run_sweep)
    sizes = (tuple(int(s) for s in args.sizes.split(",")) if args.sizes
             else DEFAULT_SIZES)
    res = run_sweep(sizes=sizes, num_rays=args.rays,
                    world_size=args.world_size, seed=args.seed,
                    device=resolve_device(args.device))
    res.save_data_txt("benchmark_data.txt")      # src/benchmark.c:160-170
    rec = res.to_json()
    with open("benchmark_results.json", "w") as f:
        json.dump(rec, f, indent=2)
    plot_sweep(res, "benchmark_results.png")     # replaces gnuplot's PNG
    print(json.dumps(rec["complexity"], indent=2))
    print("wrote benchmark_data.txt benchmark_results.json "
          "benchmark_results.png")
    return 0


def cmd_viz(args) -> int:
    """Build the tree, print ``bvh_stats``, render the scene by brute force
    and write it with the tree's boxes down to ``--viz-depth`` drawn
    over it."""
    from tracer_torch.bvh.builder import build_bvh
    from tracer_torch.bvh.flat import bvh_stats
    from tracer_torch.config import TracerConfig
    from tracer_torch.integrator.wavefront import bounce_noise, render
    from tracer_torch.intersect.brute import nearest_hit_brute
    from tracer_torch.viz.wireframe import draw_bvh_wireframe
    device = resolve_device(args.device)
    cfg = TracerConfig(width=args.width, height=args.height,
                       max_depth=args.depth)
    scene, cam = make_scene_camera(args, device)
    bvh = build_bvh(scene.centers, scene.radii, device=device)
    print(json.dumps(bvh_stats(bvh, scene.centers.shape[0]), indent=2))
    noise = bounce_noise(torch.Generator(device).manual_seed(1),
                         (cfg.height, cfg.width), cfg.max_depth)
    img = render(scene, cam, None,
                 lambda s: (lambda r: nearest_hit_brute(r, s)), cfg,
                 noise=noise)
    overlay = draw_bvh_wireframe(img.cpu().numpy(), bvh, cam, cfg,
                                 max_draw_depth=args.viz_depth)
    write_png(args.out, to_uint8(overlay))
    print(f"wrote {args.out}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tracer_torch",
                                description="SAH-BVH ray tracer on PyTorch "
                                            "and CUDA")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
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
        sp.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the plain "
                             "versions of the kernels)")

    sp = sub.add_parser("render", help="render frames to PNG and .npy")
    common(sp)
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
    sp.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the frames, the "
                         "program's tracer_torch.* spans beside the kernels, "
                         "into DIR/trace.json")
    sp.add_argument("--checkpoint", default=None,
                    help="accumulation checkpoint path (npz), written after "
                         "each frame")
    sp.add_argument("--resume", action="store_true",
                    help="resume accumulation from --checkpoint")
    sp.add_argument("--metrics", default=None,
                    help="write frame-time/FPS JSON here (with --profile "
                         "also the trace's counters)")
    sp.add_argument("--out", default="render.png")
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("bench", help="BVH vs brute-force sweep (writes its "
                                      "three files into the working "
                                      "directory)")
    sp.add_argument("--sizes", default=None,
                    help="comma-separated sphere counts (default: the "
                         "reference's 5k-50k sweep)")
    sp.add_argument("--rays", type=int, default=131072)
    sp.add_argument("--world-size", type=float, default=1000.0)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu times the plain "
                         "versions on the host clock)")
    sp.set_defaults(fn=cmd_bench)

    sp = sub.add_parser("fit", help="inverse-rendering demo (writes its "
                                    "four files into the working directory)")
    common(sp)
    sp.add_argument("--steps", type=int, default=100)
    sp.add_argument("--lr", type=float, default=3e-2)
    sp.add_argument("--sharpness", type=float, default=12.0)
    sp.add_argument("--tau", type=float, default=0.3)
    sp.add_argument("--checkpoint", default=None,
                    help="optimizer-state checkpoint path (npz)")
    sp.add_argument("--checkpoint-every", type=int, default=50)
    sp.add_argument("--resume", action="store_true")
    sp.set_defaults(fn=cmd_fit)

    sp = sub.add_parser("viz", help="BVH wireframe overlay and statistics")
    common(sp)
    sp.add_argument("--viz-depth", type=int, default=8)
    sp.add_argument("--out", default="bvh_viz.png")
    sp.set_defaults(fn=cmd_viz)
    return p


def main(argv=None) -> int:
    """Run one command; ``TRACER_DEBUG`` sanitizes it (``debug.py``)."""
    from tracer_torch.debug import enable_debug, maybe_enable_debug
    args = build_parser().parse_args(argv)
    level = maybe_enable_debug()
    try:
        return args.fn(args)
    finally:
        if level:
            enable_debug(0)


if __name__ == "__main__":
    sys.exit(main())
