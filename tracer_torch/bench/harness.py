"""Benchmark sweep: BVH against brute force over scene sizes, on the card.

PyTorch counterpart of ``tracer/bench/harness.py`` (the reference's
``run_benchmark_with_plotting``, src/benchmark.c:283-332): for each sphere
count, the reference's random scene (r = 0.5 in a world_size^3 cube), a
batch of origin rays timed through closest hit with and without the BVH,
and the complexity fits of ``results/main.py`` (a log-log slope for brute
force, a log fit and a log-log slope for the BVH). The data file matches
``results/benchmark_data.txt`` ("n brute_s bvh_s").

Each row runs the query the port would run at that size (:func:`row_query`):
the dense sweep up to ``dense_limit`` spheres, the single-chunk leaf walk
(prep, phase A with two compactions, ``leafcull_cuda``) while the tables
fit one chunk, and the TLAS-routed walk (routing, and phase A with two
compactions per block of pairs, ``routed_cuda``) beyond, at the JAX
harness's budgets for the table's chunk count (``bench.large.budgets``);
from ``device_build_min_n`` spheres the tree is the device LBVH, timed on
one build after a warm-up and kept. A query that overflows its budgets is
re-run with every budget doubled until it does not, and then timed at the
budgets it settled on; the row's path names the doublings, and a query
that still overflows at the budgets' caps raises. Brute force is the plain
min-t over 65,536-sphere chunks, on fewer rays where the pair block would
pass 2^28 elements, scaled to ``num_rays``; above ``brute_limit`` spheres
it is skipped (NaN) and the scene is freed once the tables hold it, as the
JAX harness does at 100M. Each row also records its table chunks, settled
budgets, escalations, the host's scene and table times and the card's
peak memory (``row_stats``).

Times are CUDA events on the card (``timing.time_cuda``: the whole query,
no carry between calls, so neither a NaN carry nor a negative slope can
occur) and the host clock on the CPU (``timing.time_host``), which only
tests ask for. Without a device argument the sweep runs on the card and
raises where there is none.

Deviations from the JAX harness: scenes come from
``torch.Generator().manual_seed(seed + n)``, the JAX scene's distribution
but not its numbers (the rays are the same: numpy, ``seed``); an
overflowing query is escalated where JAX records a degraded row; the tree
is freed once the tables hold it; the JSON names the card and its power
limit (``device``) and adds ``row_stats``.
"""

from __future__ import annotations

import dataclasses
import subprocess
import time
from typing import Callable

import numpy as np
import torch

from tracer_torch.bench.large import budgets as routed_budgets
from tracer_torch.bench.timing import Clock, time_cuda, time_host
from tracer_torch.bvh.builder import build_bvh
from tracer_torch.bvh.device import build_bvh_device
from tracer_torch.cli import DENSE_MAX_SPHERES
from tracer_torch.core.device import default_device
from tracer_torch.intersect.brute import brute_t_fast
from tracer_torch.intersect.sphere import ray_sphere_t
from tracer_torch.kernels.conecull import (build_cone_tables,
                                           kernel_order_dest,
                                           nearest_hit_hybrid_feats)
from tracer_torch.kernels.leafcull import prep_feats_bucketed
from tracer_torch.kernels.tlas import nearest_hit_tlas_feats
from tracer_torch.scene.scene import benchmark_scene

DEFAULT_SIZES = (5000, 10000, 15000, 20000, 25000, 30000, 35000, 40000,
                 45000, 50000)          # src/benchmark.c:289-295
PUBLISHED_SIZES = (1000, 10000, 100000, 1000000, 10000000, 100000000)
CHUNK = 65536           # spheres per brute-force chunk
PAIR_CAP = 1 << 28      # (rays x chunk) elements of one brute-force block
LEAF_SIZE = 32
S, SP, CELL_BITS, MC = 8, 128, 8, 119   # harness.py:244-251, 287


@dataclasses.dataclass
class SweepResult:
    sizes: list
    brute_s: list          # seconds per batch (NaN where skipped),
                           # scaled from brute_nb timed rays
    bvh_s: list            # seconds per batch, end to end (prep included)
    build_ms: list
    num_rays: int
    path: str              # the walks' implementation: cuda or plain
    brute_nb: list = dataclasses.field(default_factory=list)
    row_paths: list = dataclasses.field(default_factory=list)  # per size
    row_stats: list = dataclasses.field(default_factory=list)  # per size
    device: str = ""       # the card's name and power limit, or "cpu"

    def speedups(self):
        return [b / v if (b == b and v == v and v > 0) else float("nan")
                for b, v in zip(self.brute_s, self.bvh_s)]

    def mrays_bvh(self):
        return [self.num_rays / v / 1e6 if v == v and v > 0 else float("nan")
                for v in self.bvh_s]

    def to_json(self) -> dict:
        return {
            "sizes": list(map(int, self.sizes)),
            "brute_s": self.brute_s,
            "bvh_s": self.bvh_s,
            "build_ms": self.build_ms,
            "num_rays": self.num_rays,
            "brute_nb_timed": list(map(int, self.brute_nb)),
            "brute_note": "brute times at large n are linear extrapolations "
                          "from brute_nb_timed rays (work product capped)",
            "speedup": self.speedups(),
            "mrays_bvh": self.mrays_bvh(),
            "path": self.path,
            "row_paths": self.row_paths,
            "complexity": complexity_fit(self.sizes, self.brute_s, self.bvh_s),
            "device": self.device,
            "row_stats": self.row_stats,
        }

    def save_data_txt(self, path: str) -> None:
        """results/benchmark_data.txt-compatible: 'n brute_s bvh_s' rows."""
        with open(path, "w") as f:
            for n, b, v in zip(self.sizes, self.brute_s, self.bvh_s):
                f.write(f"{n} {b:.6f} {v:.6f}\n")


def complexity_fit(sizes, brute_s, bvh_s) -> dict:
    """The fits of results/main.py:20-87: brute ~ O(n) (log-log slope ~ 1),
    BVH ~ O(log n) (log fit, log-log slope << 1)."""
    n = np.asarray(sizes, np.float64)
    out = {}
    bb = np.asarray(brute_s, np.float64)
    vv = np.asarray(bvh_s, np.float64)
    ok = np.isfinite(bb)
    if ok.sum() >= 2:
        slope = np.polyfit(np.log(n[ok]), np.log(bb[ok]), 1)[0]
        out["brute_loglog_slope"] = float(slope)
    ok = np.isfinite(vv) & (vv > 0)
    if ok.sum() >= 2:
        slope = np.polyfit(np.log(n[ok]), np.log(vv[ok]), 1)[0]
        out["bvh_loglog_slope"] = float(slope)
        # log fit: t = b*log(n) + a (results/main.py:24-26)
        coef = np.polyfit(np.log(n[ok]), vv[ok], 1)
        out["bvh_logfit"] = [float(coef[0]), float(coef[1])]
    return out


def origin_rays(num_rays: int, seed: int, device):
    """The sweep's rays (harness.py:170-174): origins at 0, directions
    uniform in the cube, normalised, from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(-1, 1, (num_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = torch.as_tensor(d, device=device)
    return torch.zeros_like(d), d


def brute_rays(num_rays: int, n: int) -> int:
    """Rays brute force is timed on: halved from ``num_rays`` (down to
    2048) while the (rays, chunk) pair block passes ``PAIR_CAP``."""
    nb = num_rays
    while nb > 2048 and nb * min(n, CHUNK) > PAIR_CAP:
        nb //= 2
    return nb


def brute_t(o, d, centers, radii):
    """Brute-force closest hit over ``CHUNK``-sphere chunks with the
    reference quadratic: (t (B,), +inf on miss; sphere id (B,) i64, -1 on
    miss), the lowest id among equal t."""
    best = torch.full((o.shape[0],), float("inf"), device=o.device)
    ids = torch.full((o.shape[0],), -1, dtype=torch.int64, device=o.device)
    for i in range(0, centers.shape[0], CHUNK):
        t = ray_sphere_t(o[:, None], d[:, None], centers[None, i:i + CHUNK],
                         radii[None, i:i + CHUNK])
        tm, j = torch.min(t, dim=1)
        better = tm < best
        best = torch.where(better, tm, best)
        ids = torch.where(better, j + i, ids)
    return best, ids


def _prep_query(walk, o, d, tables, *budgets):
    """Prep, then ``walk(feats, tables, *budgets)`` (the single-chunk or
    the routed query): (t, slot, dest in the walk's order, overflow)."""
    feats, dest = prep_feats_bucketed(o, d, S, SP, cell_bits=CELL_BITS)
    t, slot, overflow = walk(feats, tables, *budgets)
    return t, slot, kernel_order_dest(dest, S, SP), overflow


def _settle(run, start, cap, log: Callable = lambda *a: None):
    """Budgets ``run(*b)`` settles on: from ``start``, every budget doubled
    (up to ``cap``) while the query overflows, as the checked drivers
    escalate, each doubling logged. Returns (budgets, doublings); raises
    RuntimeError if the query overflows at ``cap``."""
    b = tuple(min(x, c) for x, c in zip(start, cap))
    esc = 0
    while bool(run(*b)[-1]):
        if b == tuple(cap):
            raise RuntimeError(f"the query overflows at its caps {b}")
        nb = tuple(min(2 * x, c) for x, c in zip(b, cap))
        log(f"overflow at budgets {b}: doubled to {nb}")
        b, esc = nb, esc + 1
    return b, esc


def row_query(n: int, scene, tables, o, d, dense_limit: int = 4000,
              log: Callable = lambda *a: None):
    """The closest-hit query of one sweep row, without timing.

    Returns (query, path, escalations, budgets): ``query()`` runs the
    whole query and gives (t (B,), +inf on miss; sphere id (B,), -1 on
    miss) in the rays' order. Up to ``dense_limit`` spheres it is the dense
    sweep (``brute_t_fast``; ``tables`` unused, budgets None); else prep,
    phase A and the single-chunk leaf walk when ``tables`` hold one chunk
    (budgets (max_groups, max_candidates)), or the TLAS-routed walk at the
    JAX harness's budgets (``bench.large.budgets``; budgets (max_groups,
    max_candidates, npairs, kc)); either re-run with doubled budgets while
    it overflows (``_settle``, each doubling logged), ``escalations`` the
    doublings it took. ``scene`` is read only by the dense sweep."""
    if n <= dense_limit:
        return (lambda: brute_t_fast(o, d, scene.centers, scene.radii),
                "dense_brute_fast", 0, None)
    cull = tables.cull
    C = cull.num_chunks
    if C == 1:
        mg = 64 if n <= 300_000 else (128 if n <= 3_000_000 else 256)
        walk, extra, path = nearest_hit_hybrid_feats, (), "hybrid_feats"
        start, cap = (mg, MC), (cull.num_groups, cull.leaves_per_chunk)
    else:
        g = prep_feats_bucketed(o, d, S, SP, cell_bits=CELL_BITS)[0].shape[0]
        mg, npairs, kc, pair_block = routed_budgets(n, C, o.shape[0])
        walk, extra, path = nearest_hit_tlas_feats, (pair_block,), \
            "tlas_routed"
        start = (mg, MC, min(npairs, C * g), kc)
        cap = (cull.leaves_per_chunk // cull.leaves_per_group,
               cull.leaves_per_chunk, C * g, C)
    budgets, esc = _settle(
        lambda *b: _prep_query(walk, o, d, tables, *b, *extra), start, cap,
        log)

    def query():
        t, slot, dest, _ = _prep_query(walk, o, d, tables, *budgets, *extra)
        t, slot = t[dest], slot[dest]
        hit = slot >= 0
        sid = torch.where(hit, cull.slot_to_sphere[slot.clamp(min=0).long()],
                          -1)
        return t, sid
    return query, path + (f"_escalated{esc}" if esc else ""), esc, budgets


def sweep_scene(n: int, seed: int, world_size: float, device):
    """The sweep's scene of ``n`` spheres: ``benchmark_scene`` drawn from
    ``torch.Generator().manual_seed(seed + n)``."""
    return benchmark_scene(torch.Generator().manual_seed(seed + n), n,
                           world_size=world_size, device=device)


def _host_timed(dev, fn, *args):
    """(fn(*args), milliseconds on the host clock until the card, if
    ``dev`` is one, has finished the work it queued)."""
    t0 = time.perf_counter()
    out = fn(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, (time.perf_counter() - t0) * 1e3


def card_name(device) -> str:
    """The card's name and power limit as nvidia-smi reports them, or
    "cpu"."""
    if device.type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    line = smi.stdout.strip().splitlines()
    return line[0] if smi.returncode == 0 and line else \
        torch.cuda.get_device_name(device)


def run_sweep(sizes=DEFAULT_SIZES, num_rays: int = 131072,
              world_size: float = 1000.0, brute_limit: int = 20_000_000,
              seed: int = 0, dense_limit: int = DENSE_MAX_SPHERES,
              device_build_min_n: int = 5_000_000, device=None,
              log: Callable = print) -> SweepResult:
    """Run the sweep. The default sizes are the reference's in-repo sweep
    (src/benchmark.c:289-295); ``PUBLISHED_SIZES`` are the decades of its
    published data (src/benchmark.c:296) and the JAX package's 100M row.
    Brute force is skipped above ``brute_limit`` spheres. ``device``
    defaults to the card; the CPU must be asked for."""
    dev = default_device(device)
    cuda = dev.type == "cuda"
    timer = time_cuda if cuda else time_host
    o, d = origin_rays(num_rays, seed, dev)
    res = SweepResult(sizes=list(sizes), brute_s=[], bvh_s=[], build_ms=[],
                      num_rays=num_rays,
                      path="cuda" if cuda else "plain",
                      device=card_name(dev))
    for n in sizes:
        n = int(n)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        scene, scene_ms = _host_timed(dev, sweep_scene, n, seed, world_size,
                                      dev)
        lbvh = n >= device_build_min_n
        if lbvh:
            # One build to warm the allocator, then one timed build kept:
            # two trees' temporaries are never live together.
            build_bvh_device(scene.centers, scene.radii, LEAF_SIZE)
            clock = Clock(dev)
            clock.start()
            bvh = build_bvh_device(scene.centers, scene.radii, LEAF_SIZE)
            res.build_ms.append(clock.stop() * 1e3)
        else:
            t0 = time.perf_counter()
            bvh = build_bvh(scene.centers, scene.radii, leaf_size=LEAF_SIZE,
                            device=dev)
            res.build_ms.append((time.perf_counter() - t0) * 1e3)

        if n <= brute_limit:
            nb = brute_rays(num_rays, n)
            ms = timer(brute_t, o[:nb], d[:nb], scene.centers, scene.radii,
                       warmup=1, iters=3)
            res.brute_s.append(ms * 1e-3 * (num_rays / nb))
            res.brute_nb.append(nb)
        else:
            res.brute_s.append(float("nan"))
            res.brute_nb.append(0)

        tables, tables_ms = ((None, 0.0) if n <= dense_limit else
                             _host_timed(dev, build_cone_tables, scene, bvh))
        bvh = None
        if tables is not None and n > brute_limit:
            scene = None        # the query reads only the tables
        query, path, esc, budgets = row_query(n, scene, tables, o, d,
                                              dense_limit, log)
        res.row_paths.append(path + ("_lbvh" if lbvh else ""))
        res.bvh_s.append(timer(query) * 1e-3)
        chunks = tables.cull.num_chunks if tables is not None else 0
        peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 20 if cuda
                else float("nan"))
        res.row_stats.append({
            "chunks": chunks, "budgets": budgets and list(budgets),
            "escalations": esc, "scene_ms": scene_ms,
            "tables_ms": tables_ms, "peak_mib": peak})
        log(f"n={n}: {res.row_paths[-1]} ({chunks} table chunk(s), budgets "
            f"{budgets}), scene {scene_ms:.0f} ms, build "
            f"{res.build_ms[-1]:.0f} ms, tables {tables_ms:.0f} ms, brute "
            f"{res.brute_s[-1]:.4f} s, bvh {res.bvh_s[-1]:.4f} s "
            f"({res.mrays_bvh()[-1]:.1f} Mrays/s), {esc} escalation(s), "
            f"peak {peak:.1f} MiB")
        scene = tables = query = None
    return res


def plot_sweep(res: SweepResult, path: str, width: int = 640,
               height: int = 400) -> None:
    """Log-log plot of BVH (blue) and brute-force (red) seconds against
    sphere count, as PNG: axes with a tick at each decade, a square at each
    point; no text (the JSON is the record). The gnuplot plot of
    src/benchmark.c:90-136."""
    from tracer_torch.cli import to_uint8, write_png
    from tracer_torch.viz.wireframe import draw_line

    img = np.ones((height, width, 3), np.float32)
    m = 40
    n = np.log10(np.asarray(res.sizes, np.float64))
    ys = [np.log10(np.asarray(s, np.float64)) for s in (res.brute_s,
                                                         res.bvh_s)]
    fin = np.concatenate([y[np.isfinite(y)] for y in ys])
    x0, x1 = np.floor(n.min()), np.ceil(n.max())
    y0, y1 = np.floor(fin.min()), np.ceil(fin.max())
    x1, y1 = max(x1, x0 + 1), max(y1, y0 + 1)

    def px(x, y):
        return (m + (x - x0) / (x1 - x0) * (width - 2 * m),
                height - m - (y - y0) / (y1 - y0) * (height - 2 * m))

    black = np.zeros(3, np.float32)
    draw_line(img, *px(x0, y0), *px(x1, y0), black)
    draw_line(img, *px(x0, y0), *px(x0, y1), black)
    for k in np.arange(x0, x1 + 1):
        xa, ya = px(k, y0)
        draw_line(img, xa, ya, xa, ya + 6, black)
    for k in np.arange(y0, y1 + 1):
        xa, ya = px(x0, k)
        draw_line(img, xa - 6, ya, xa, ya, black)
    for y, color in zip(ys, ([0.85, 0.1, 0.1], [0.1, 0.2, 0.85])):
        color = np.asarray(color, np.float32)
        pts = [px(a, b) for a, b in zip(n, y) if np.isfinite(b)]
        for (xa, ya), (xb, yb) in zip(pts, pts[1:]):
            draw_line(img, xa, ya, xb, yb, color)
        for xa, ya in pts:
            img[max(int(ya) - 2, 0):int(ya) + 3,
                max(int(xa) - 2, 0):int(xa) + 3] = color
    write_png(path, to_uint8(img))
