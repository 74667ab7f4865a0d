"""The distribution on ``torch.distributed``: meshes, ray-sharded queries
and rendering, the ring over scene shards and the sharded training step.

PyTorch counterpart of ``tracer/dist``. Every function is SPMD: each rank
calls it with the same full arrays, takes its shard by its rank in the
mesh axis's process group, and gets the full result back.
"""

from tracer_torch.dist.mesh import (RAY_AXIS, SCENE_AXIS, init_distributed,
                                    ray_mesh, scene_mesh)
from tracer_torch.dist.shard import nearest_hit_sharded, render_sharded
from tracer_torch.dist.ring import (ShardedBVH, build_sharded_bvh,
                                    nearest_hit_ring)
from tracer_torch.dist.train import AdamState, make_train_step

__all__ = [
    "RAY_AXIS", "SCENE_AXIS", "init_distributed", "ray_mesh", "scene_mesh",
    "render_sharded", "nearest_hit_sharded", "nearest_hit_ring",
    "ShardedBVH", "build_sharded_bvh", "AdamState", "make_train_step",
]
