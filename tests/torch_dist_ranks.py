"""Gloo ranks on the CPU for the port's distributed tests.

This module imports torch and ``tracer_torch`` only: no JAX and nothing of
``tests.conftest``, since every spawned rank imports it. A test module
builds its inputs (numpy arrays, some drawn by the JAX package) in the
pytest process and calls :func:`run` once; :func:`run` spawns the ranks,
each rank runs every named scenario in order on the same inputs, and every
rank's results come back as numpy.

The ranks meet through a ``FileStore`` in the caller's temporary directory
(no TCP port), run torch on one thread each, and give up on a collective
after ``TIMEOUT``.
"""

from __future__ import annotations

import datetime
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT = datetime.timedelta(seconds=180)
CPU = "cpu"


def np_(x) -> np.ndarray:
    return x.detach().cpu().numpy().copy()


def run(world: int, scenarios: list[str], inputs: dict, tmpdir) -> list:
    """Spawn ``world`` gloo ranks; each runs ``SCENARIOS[name](inputs)`` for
    every name in order. Returns each rank's {name: result}, rank order."""
    tmpdir = str(tmpdir)
    with open(os.path.join(tmpdir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    mp.spawn(_rank_main, args=(world, scenarios, tmpdir), nprocs=world,
             join=True)
    out = []
    for rank in range(world):
        with open(os.path.join(tmpdir, f"rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _rank_main(rank: int, world: int, scenarios: list[str], tmpdir: str):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(tmpdir, 'store')}",
        rank=rank, world_size=world, timeout=TIMEOUT)
    try:
        with open(os.path.join(tmpdir, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)
        results = {name: SCENARIOS[name](inputs) for name in scenarios}
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmpdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


# ---------------------------------------------------------------------------
# Scenarios: scenario(inputs) -> dict of numpy arrays (or plain values)
# ---------------------------------------------------------------------------

def _scene(c, r, a=None):
    from tracer_torch.interop import scene_from_numpy
    return scene_from_numpy(c, r, a, device=CPU)


def _rays(o, d):
    from tracer_torch.core.types import Ray
    return Ray(origin=torch.as_tensor(o), direction=torch.as_tensor(d))


def _record(rec) -> dict:
    return {"t": np_(rec.t), "index": np_(rec.index), "hit": np_(rec.hit)}


def sharded_brute(inp):
    """nearest_hit_sharded over a ray mesh of every rank, brute force,
    and the unsharded brute force."""
    from tracer_torch.dist import nearest_hit_sharded, ray_mesh
    from tracer_torch.intersect.brute import nearest_hit_brute
    scene = _scene(*inp["query_scene"])
    rays = _rays(*inp["query_rays"])
    got = nearest_hit_sharded(rays, scene, ray_mesh(device=CPU),
                              nearest_hit_brute)
    return {"sharded": _record(got),
            "unsharded": _record(nearest_hit_brute(rays, scene))}


def sharded_leafwalk(inp):
    """nearest_hit_sharded through the escalating leaf walk (its plain
    version on the CPU), each rank sorting and bucketing its own rays into
    subpackets of 32 (rows in group mode at these budgets), and the same
    query unsharded."""
    from tracer_torch.bvh.builder import build_bvh
    from tracer_torch.dist import nearest_hit_sharded, ray_mesh
    from tracer_torch.kernels.conecull import build_cone_tables
    from tracer_torch.kernels.leafcull import nearest_hit_leafcull_checked
    c, r, a = inp["walk_scene"]
    scene = _scene(c, r, a)
    tables = build_cone_tables(scene, build_bvh(c, r, leaf_size=8,
                                                device=CPU))
    rays = _rays(*inp["walk_rays"])

    def query(q, s):
        return nearest_hit_leafcull_checked(q, s, tables, 8, 16,
                                            subpackets=2, subpacket=32)[0]
    got = nearest_hit_sharded(rays, scene, ray_mesh(device=CPU), query)
    return {"sharded": _record(got), "unsharded": _record(query(rays, scene))}


def sharded_render(inp):
    """render_sharded (brute force) on a generator, and the unsharded
    render on noise drawn from the same generator state."""
    from tracer_torch.config import TracerConfig
    from tracer_torch.dist import ray_mesh, render_sharded
    from tracer_torch.integrator.wavefront import bounce_noise, render
    from tracer_torch.intersect.brute import nearest_hit_brute
    from tracer_torch.scene.camera import Camera
    scene = _scene(*inp["render_scene"])
    w, h, depth, seed = inp["render_cfg"]
    cfg = TracerConfig(width=w, height=h, max_depth=depth)
    cam = Camera.default(CPU)
    got = render_sharded(scene, cam, torch.Generator().manual_seed(seed),
                         ray_mesh(device=CPU), nearest_hit_brute, cfg)
    noise = bounce_noise(torch.Generator().manual_seed(seed), (h, w), depth)
    ref = render(scene, cam, None,
                 lambda s: (lambda q: nearest_hit_brute(q, s)), cfg,
                 noise=noise)
    return {"sharded": np_(got), "unsharded": np_(ref), "noise": np_(noise)}


def ring_brute(inp):
    """nearest_hit_ring over the ray mesh's only axis, brute force."""
    from tracer_torch.dist import RAY_AXIS, nearest_hit_ring, ray_mesh
    got = nearest_hit_ring(_rays(*inp["ring_rays"]),
                           _scene(*inp["ring_scene"]), ray_mesh(device=CPU),
                           axis=RAY_AXIS)
    return _record(got)


def ring_bvh(inp):
    """build_sharded_bvh with a shard per rank, and the ring through it."""
    from tracer_torch.dist import (RAY_AXIS, build_sharded_bvh,
                                   nearest_hit_ring, ray_mesh)
    c, r = inp["ring_bvh_scene"]
    world = dist.get_world_size()
    sbvh = build_sharded_bvh(c, r, num_shards=world, leaf_size=8, device=CPU)
    got = nearest_hit_ring(_rays(*inp["ring_bvh_rays"]), _scene(c, r),
                           ray_mesh(device=CPU), axis=RAY_AXIS, sbvh=sbvh)
    out = _record(got)
    if dist.get_rank() == 0:
        out["sbvh"] = {k: np_(getattr(sbvh, k)) for k in (
            "node_min", "node_max", "escape", "leaf_start", "prim_idx")}
        out["sbvh_sizes"] = (sbvh.shard_size, sbvh.leaf_size)
    return out


def ring_one_shard(inp):
    """The ring over a scene axis of size 1 (no send), brute force and
    through a one-shard BVH, and the unsharded brute force."""
    from tracer_torch.dist import (SCENE_AXIS, build_sharded_bvh,
                                   nearest_hit_ring, scene_mesh)
    from tracer_torch.intersect.brute import nearest_hit_brute
    c, r = inp["ring_scene"][:2]
    scene = _scene(c, r)
    rays = _rays(*inp["ring_rays"])
    mesh = scene_mesh(scene_shards=1, device=CPU)
    sbvh = build_sharded_bvh(c, r, num_shards=1, leaf_size=8, device=CPU)
    return {"brute": _record(nearest_hit_ring(rays, scene, mesh,
                                              axis=SCENE_AXIS)),
            "bvh": _record(nearest_hit_ring(rays, scene, mesh,
                                            axis=SCENE_AXIS, sbvh=sbvh)),
            "ref": _record(nearest_hit_brute(rays, scene))}


def mesh_shapes(inp):
    """Mesh shapes: scene_mesh's defaults and explicit counts, ray_mesh,
    and each axis group's rank list."""
    from tracer_torch.dist import RAY_AXIS, SCENE_AXIS, ray_mesh, scene_mesh
    out = {}
    for name, kw in (("default", {}), ("rays4", {"ray_shards": 4}),
                     ("scene4", {"scene_shards": 4}),
                     ("8x1", {"ray_shards": 8, "scene_shards": 1})):
        m = scene_mesh(device=CPU, **kw)
        out[name] = (tuple(m.shape), m.mesh_dim_names,
                     dist.get_process_group_ranks(m.get_group(RAY_AXIS)),
                     dist.get_process_group_ranks(m.get_group(SCENE_AXIS)))
    m = ray_mesh(device=CPU)
    out["ray"] = (tuple(m.shape), m.mesh_dim_names)
    out["ray2_coordinate"] = ray_mesh(2, device=CPU).get_coordinate()
    return out


def scaling(inp):
    """measure_scaling over sub-meshes of 1, 2 and 8 ranks."""
    from tracer_torch.bench.scaling import measure_scaling
    from tracer_torch.intersect.brute import nearest_hit_brute
    return measure_scaling(_scene(*inp["scaling_scene"]),
                           _rays(*inp["scaling_rays"]), nearest_hit_brute,
                           device_counts=[1, 2, 8], reps=2)


def _train_problem(inp, key, shape=None, k_top=None):
    """(params, state, step_fn, o, d, zero target) of a training step on
    ``shape`` (default: the input's own) with per-shard budget ``k_top``
    (default: the input's own; None there: the step's default)."""
    from tracer_torch.dist import make_train_step, scene_mesh
    c, r, a, o, d, shape0, k0 = inp[key]
    mesh = scene_mesh(*(shape or shape0), device=CPU)
    k_top = k0 if k_top is None else k_top
    kw = {} if k_top is None else {"k_top": k_top}
    init_fn, factory = make_train_step(mesh, lr=1e-2, **kw)
    params, state = init_fn(_scene(c, r, a))
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    return params, state, factory(state), o, d, torch.zeros_like(o)


def train_direct(inp):
    """Two sharded training steps on a (4, 2) mesh."""
    params, state, step, o, d, target = _train_problem(inp, "train_direct")
    p0 = np_(params["centers"])
    params, state, l1 = step(params, state, o, d, target)
    params, state, l2 = step(params, state, o, d, target)
    return {"p0": p0, "p2": np_(params["centers"]), "l1": float(l1),
            "l2": float(l2), "count": state.count}


def _unsharded_loss(params, o, d, target, grad=True):
    """The unsharded soft_render loss of the parameters, and its gradient
    ({name: array}) with ``grad``."""
    from tracer_torch.core.types import Ray
    from tracer_torch.diff.fit import params_to_scene
    from tracer_torch.diff.soft import soft_render
    ref_p = {k: v.clone().requires_grad_(grad) for k, v in params.items()}
    img = soft_render(params_to_scene(ref_p), None,
                      rays=Ray(origin=o, direction=d))
    loss = torch.mean((img - target) ** 2)
    if not grad:
        return float(loss)
    grads = torch.autograd.grad(loss, [ref_p[k] for k in sorted(ref_p)])
    return float(loss.detach()), {k: np_(g) for k, g in zip(sorted(ref_p),
                                                            grads)}


def train_loss(inp):
    """One sharded step on each mesh shape of the input, every sphere a
    candidate (k_top the shard size): its loss and Adam moments by shape,
    and the unsharded soft_render loss and gradient on the same
    parameters."""
    c = inp["train_loss"][0]
    out = {}
    for shape in inp["train_loss"][5]:
        k_top = len(c) // shape[1]
        params, state, step, o, d, target = _train_problem(
            inp, "train_loss", shape, k_top)
        if not out:
            out["ref_loss"], out["ref_grad"] = _unsharded_loss(params, o, d,
                                                               target)
        _, state, loss = step(params, state, o, d, target)
        out[shape] = {"loss": float(loss),
                      "mu": {k: np_(v) for k, v in state.mu.items()},
                      "nu": {k: np_(v) for k, v in state.nu.items()}}
    return out


def train_topk(inp):
    """One sharded step whose k_top is below the shard size: its loss, the
    unsharded loss, and the mean over rays of the sum of the sigmas that
    the per-shard truncation drops."""
    from tracer_torch.diff.fit import params_to_scene
    from tracer_torch.diff.soft import SoftParams, _shade_sigma_t
    params, state, step, o, d, target = _train_problem(inp, "train_topk")
    _, _, _, _, _, (_, S), k_top = inp["train_topk"]
    with torch.no_grad():
        sigma = _shade_sigma_t(params_to_scene(params), o, d, SoftParams())[0]
        shards = sigma.reshape(sigma.shape[0], S, -1)
        tail = torch.sort(shards, dim=2, descending=True).values[..., k_top:]
        dropped = tail.sum((1, 2))
    _, _, loss = step(params, state, o, d, target)
    return {"loss": float(loss),
            "ref_loss": _unsharded_loss(params, o, d, target, grad=False),
            "dropped": float(dropped.mean())}


def _fit(inp, key="fit", **kw):
    from tracer_torch.config import TracerConfig
    from tracer_torch.diff.fit import fit_scene
    from tracer_torch.scene.camera import Camera
    c, r, a, target, (w, h), steps = inp[key][:6]
    camera = Camera.default(CPU)
    if key == "camera_fit":
        (yaw, position), lr = inp[key][6:]
        camera = camera.replace(yaw=torch.tensor(yaw),
                                position=torch.as_tensor(position))
        kw.update(optimize_camera=True, lr=lr)
    kw.setdefault("steps", steps)
    res = fit_scene(torch.as_tensor(target), _scene(c, r, a), camera,
                    config=TracerConfig(width=w, height=h, max_depth=1),
                    **kw)
    return {"losses": res.losses, "centers": np_(res.scene.centers),
            "radii": np_(res.scene.radii), "albedo": np_(res.scene.albedo),
            **{k: np_(getattr(res.camera, k)) for k in ("position", "yaw",
                                                        "pitch")}}


def fit(inp):
    """fit_scene on a ray mesh of every rank with one all-reduce (T = 1)
    and with four overlapped tiles (T = 4), and one step of T = 1, each
    writing its final checkpoint; fit_scene on a mesh of rank 0 alone
    and the unsharded fit on rank 0."""
    from tracer_torch.dist import ray_mesh
    mesh = ray_mesh(device=CPU)
    ck = inp["fit_checkpoints"]
    out = {f"t{t}": _fit(inp, mesh=mesh, grad_microbatch=t,
                         checkpoint_path=os.path.join(ck, f"t{t}.npz"))
           for t in (1, 4)}
    out["step1"] = _fit(inp, mesh=mesh, steps=1,
                        checkpoint_path=os.path.join(ck, "step1.npz"))
    one = ray_mesh(1, device=CPU)
    if one.get_coordinate() is not None:
        out["one"] = _fit(inp, mesh=one)
        out["plain"] = _fit(inp)
    return out


def camera_fit(inp):
    """fit_scene(optimize_camera=True) from a perturbed pose on a ray mesh
    of every rank (T = 1 and T = 4), and unsharded on rank 0."""
    from tracer_torch.dist import ray_mesh
    mesh = ray_mesh(device=CPU)
    out = {f"t{t}": _fit(inp, "camera_fit", mesh=mesh, grad_microbatch=t)
           for t in (1, 4)}
    if dist.get_rank() == 0:
        out["plain"] = _fit(inp, "camera_fit")
    return out


SCENARIOS = {f.__name__: f for f in (
    sharded_brute, sharded_leafwalk, sharded_render, ring_brute, ring_bvh,
    ring_one_shard, mesh_shapes, scaling, train_direct, train_loss,
    train_topk, fit, camera_fit)}
