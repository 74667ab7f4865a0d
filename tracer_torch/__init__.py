"""tracer_torch: the tracer's closest-hit and shadow queries in PyTorch,
with hand-written CUDA kernels for an NVIDIA H100.

A port of the JAX package ``tracer`` (which stays the reference). It imports
torch and never JAX. The query runs build -> prep -> phase A -> leaf walk:

    from tracer_torch import (benchmark_scene, build_bvh, build_cone_tables,
                              prep_feats_bucketed, nearest_hit_hybrid_feats,
                              kernel_order_dest)

``occluded_hybrid_feats`` is the any-hit (shadow) query on the same path;
scenes of many table chunks go through ``nearest_hit_tlas_feats`` (the
TLAS-routed path), typically over ``build_bvh_device``'s LBVH. Scenes and
trees are built on the CUDA device unless ``device`` names another.

On CUDA tensors the row compactor and the leaf walks run as CUDA kernels
built with nvcc into ``build/tracer_torch/`` on first use; on CPU tensors
they run as their plain PyTorch versions.
"""

from tracer_torch.core.types import Ray, HitRecord
from tracer_torch.scene.scene import (Scene, fixed_scene, random_scene,
                                      benchmark_scene)
from tracer_torch.intersect.sphere import (EPSILON, ray_sphere_t,
                                           hit_record_from_t)
from tracer_torch.intersect.brute import (nearest_hit_brute, any_hit_brute,
                                          brute_t_fast)
from tracer_torch.bvh.flat import FlatBVH, padded_scene_arrays, validate_bvh
from tracer_torch.bvh.builder import build_bvh
from tracer_torch.bvh.device import build_bvh_device, morton_codes_3d
from tracer_torch.interop import scene_from_numpy, flat_bvh_from_numpy
from tracer_torch.kernels.leafcull import (CullTables, build_cull_tables,
                                           prep_feats_bucketed,
                                           pack_ray_features, leafcull_call,
                                           anyhit_call)
from tracer_torch.kernels.conecull import (ConeTables, build_cone_tables,
                                           cone_candidates,
                                           compact_ascending_rows,
                                           kernel_order_dest,
                                           nearest_hit_hybrid_feats,
                                           nearest_hit_hybrid_raw,
                                           occluded_hybrid_feats)
from tracer_torch.kernels.tlas import (route_pairs, tlas_candidates,
                                       routed_call, nearest_hit_tlas_feats)

__all__ = [
    "Ray", "HitRecord", "Scene", "fixed_scene", "random_scene",
    "benchmark_scene", "EPSILON", "ray_sphere_t", "hit_record_from_t",
    "nearest_hit_brute", "any_hit_brute", "brute_t_fast", "FlatBVH",
    "padded_scene_arrays", "validate_bvh", "build_bvh", "build_bvh_device",
    "morton_codes_3d", "scene_from_numpy", "flat_bvh_from_numpy",
    "CullTables", "build_cull_tables", "prep_feats_bucketed",
    "pack_ray_features", "leafcull_call", "anyhit_call", "ConeTables",
    "build_cone_tables", "cone_candidates", "compact_ascending_rows",
    "kernel_order_dest", "nearest_hit_hybrid_feats",
    "nearest_hit_hybrid_raw", "occluded_hybrid_feats", "route_pairs",
    "tlas_candidates", "routed_call", "nearest_hit_tlas_feats",
]
