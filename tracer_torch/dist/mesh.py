"""Process groups and device meshes: the tracer's parallel layout.

PyTorch counterpart of ``tracer/dist/mesh.py`` on ``torch.distributed``.
Two mesh axes cover the parallel strategies:

  * ``rays``  -- ray/tile data parallelism: the wavefront shards across
    ranks, the scene is replicated; collectives appear only where results
    are gathered and gradients reduced.
  * ``scene`` -- scene/parameter sharding: sphere arrays shard across ranks
    and partial hits min-reduce around a ring (:mod:`tracer_torch.dist.ring`)
    or per-shard candidates are gathered (:mod:`tracer_torch.dist.train`).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with those
dimension names; ``mesh.get_group(RAY_AXIS)`` is the ray axis's process
group. The port's distributed functions are SPMD: every rank calls one with
the same full arrays, takes its own shard by its rank in the axis's group,
and gets the full result back, as the JAX functions return it.

The backend is NCCL on CUDA and gloo on the CPU. A multi-process run calls
:func:`init_distributed` first (or starts under ``torchrun``); when no
process group exists, the mesh functions start one of world size 1 on the
device's backend.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch import Tensor
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

RAY_AXIS = "rays"
SCENE_AXIS = "scene"


def backend_for(device) -> str:
    """The process-group backend of a device: NCCL on CUDA, gloo else."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _cuda_device(index: int) -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' for gloo ranks "
                           "on the CPU")
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_ids=None, device="cuda") -> int:
    """Multi-process entry point: join the job's process group.

    The counterpart of ``jax.distributed.initialize``. ``num_processes``
    and ``coordinator_address`` default to the ``TRACER_NUM_PROCESSES`` and
    ``TRACER_COORDINATOR`` environment variables; the rank defaults to
    ``TRACER_PROCESS_ID``, else ``RANK`` (set by ``torchrun``). Without a
    coordinator the rendezvous is ``env://`` (``MASTER_ADDR`` and
    ``MASTER_PORT``). On CUDA each process binds the card
    ``local_device_ids[0]``, else ``LOCAL_RANK``, else its rank modulo the
    card count.

    A single-process run (no coordinator and at most one process) is a
    no-op; so is a second call. Returns the world size.
    """
    env_world = int(os.environ.get("TRACER_NUM_PROCESSES", "0")) or None
    num_processes = num_processes or env_world
    coordinator_address = coordinator_address or os.environ.get(
        "TRACER_COORDINATOR")
    single = coordinator_address is None and (num_processes or 1) == 1
    if not dist.is_initialized() and not single:
        if process_id is None:
            process_id = int(os.environ.get(
                "TRACER_PROCESS_ID", os.environ.get("RANK", "0")))
        init = (f"tcp://{coordinator_address}" if coordinator_address
                else "env://")
        kw = {}
        if torch.device(device).type == "cuda":
            if local_device_ids:
                index = int(list(local_device_ids)[0])
            elif "LOCAL_RANK" in os.environ:
                index = int(os.environ["LOCAL_RANK"])
            else:
                index = process_id % max(torch.cuda.device_count(), 1)
            kw["device_id"] = _cuda_device(index)
        dist.init_process_group(backend_for(device), init_method=init,
                                world_size=num_processes, rank=process_id,
                                **kw)
    return dist.get_world_size() if dist.is_initialized() else 1


def ensure_group(device="cuda") -> int:
    """The world size, after starting a world-size-1 process group on the
    device's backend if none exists (an in-process store, no port)."""
    if not dist.is_initialized():
        kw = {}
        if torch.device(device).type == "cuda":
            kw["device_id"] = _cuda_device(torch.device(device).index or 0)
        dist.init_process_group(backend_for(device), store=dist.HashStore(),
                                world_size=1, rank=0, **kw)
    return dist.get_world_size()


def ray_mesh(n_devices: int | None = None, device="cuda") -> DeviceMesh:
    """1-D mesh over the ray axis (pure data parallelism) on the first
    ``n_devices`` ranks (all by default). Every rank of the world must call
    it, in the same order as every other mesh or group it makes."""
    world = ensure_group(device)
    return init_device_mesh(torch.device(device).type, (n_devices or world,),
                            mesh_dim_names=(RAY_AXIS,))


def scene_mesh(ray_shards: int | None = None,
               scene_shards: int | None = None,
               device="cuda") -> DeviceMesh:
    """2-D mesh (rays x scene) for joint ray and scene sharding. With
    neither count given, 2 scene shards when the world size is even and
    above 1, else 1; the ray shards fill the rest (8 ranks give (4, 2))."""
    n = ensure_group(device)
    if ray_shards is None and scene_shards is None:
        scene_shards = 2 if n % 2 == 0 and n > 1 else 1
        ray_shards = n // scene_shards
    elif ray_shards is None:
        ray_shards = n // scene_shards
    elif scene_shards is None:
        scene_shards = n // ray_shards
    return init_device_mesh(torch.device(device).type,
                            (ray_shards, scene_shards),
                            mesh_dim_names=(RAY_AXIS, SCENE_AXIS))


def axis_group(mesh: DeviceMesh, axis: str):
    """(process group, this rank's index in it, its size) of a mesh axis.
    Raises ValueError on a rank outside the mesh."""
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    group = mesh.get_group(axis)
    return group, dist.get_rank(group), dist.get_world_size(group)


def shard_rows(x: Tensor, rank: int, n: int) -> Tensor:
    """Rank ``rank``'s block of the leading dimension split ``n`` ways."""
    b = x.shape[0]
    if b % n:
        raise ValueError(f"leading dimension {b} must divide {n} shards")
    k = b // n
    return x[rank * k:(rank + 1) * k]


def all_gather_cat(x: Tensor, group, dim: int = 0) -> Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group-rank order
    (each rank's ``x`` of the same shape and dtype). Booleans travel as
    bytes."""
    src = x.to(torch.uint8) if x.dtype == torch.bool else x
    src = src.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.bool() if x.dtype == torch.bool else out


class _GatherCat(torch.autograd.Function):
    """:func:`all_gather_cat` with its transpose as the backward: each
    rank's gradient of the gathered tensor is summed over the group and
    the rank keeps its own block (a reduce-scatter by sum)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        ctx.rank = dist.get_rank(group)
        ctx.size = x.shape[dim]
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, \
            None


def all_gather_cat_grad(x: Tensor, group, dim: int = 0) -> Tensor:
    """:func:`all_gather_cat` recorded for autograd (see :class:`_GatherCat`)."""
    return _GatherCat.apply(x, group, dim)
