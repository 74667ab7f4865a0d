"""tracer_torch: the tracer's closest-hit query in PyTorch, with hand-written
CUDA kernels for an NVIDIA H100.

A port of the JAX package ``tracer`` (which stays the reference). It imports
torch and never JAX. The query runs build -> prep -> phase A -> leaf walk:

    from tracer_torch import (benchmark_scene, build_bvh, build_cone_tables,
                              prep_feats_bucketed, nearest_hit_hybrid_feats,
                              kernel_order_dest)

On CUDA tensors the row compactor and the leaf walk run as CUDA kernels
built with nvcc into ``build/tracer_torch/`` on first use; on CPU tensors
they run as their plain PyTorch versions.
"""

from tracer_torch.core.types import Ray, HitRecord
from tracer_torch.scene.scene import (Scene, fixed_scene, random_scene,
                                      benchmark_scene)
from tracer_torch.intersect.sphere import (EPSILON, ray_sphere_t,
                                           hit_record_from_t)
from tracer_torch.intersect.brute import nearest_hit_brute, brute_t_fast
from tracer_torch.bvh.flat import FlatBVH, padded_scene_arrays, validate_bvh
from tracer_torch.bvh.builder import build_bvh
from tracer_torch.interop import scene_from_numpy, flat_bvh_from_numpy
from tracer_torch.kernels.leafcull import (CullTables, build_cull_tables,
                                           prep_feats_bucketed,
                                           pack_ray_features, leafcull_call)
from tracer_torch.kernels.conecull import (ConeTables, build_cone_tables,
                                           cone_candidates,
                                           compact_ascending_rows,
                                           kernel_order_dest,
                                           nearest_hit_hybrid_feats,
                                           nearest_hit_hybrid_raw)

__all__ = [
    "Ray", "HitRecord", "Scene", "fixed_scene", "random_scene",
    "benchmark_scene", "EPSILON", "ray_sphere_t", "hit_record_from_t",
    "nearest_hit_brute", "brute_t_fast", "FlatBVH", "padded_scene_arrays",
    "validate_bvh", "build_bvh", "scene_from_numpy", "flat_bvh_from_numpy",
    "CullTables", "build_cull_tables", "prep_feats_bucketed",
    "pack_ray_features", "leafcull_call", "ConeTables", "build_cone_tables",
    "cone_candidates", "compact_ascending_rows", "kernel_order_dest",
    "nearest_hit_hybrid_feats", "nearest_hit_hybrid_raw",
]
