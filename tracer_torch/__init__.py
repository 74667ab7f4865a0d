"""tracer_torch: the tracer's queries and renderer in PyTorch, with
hand-written CUDA kernels for an NVIDIA H100.

A port of the JAX package ``tracer`` (which stays the reference). It imports
torch and never JAX. The query runs build -> prep -> phase A -> leaf walk:

    from tracer_torch import (benchmark_scene, build_bvh, build_cone_tables,
                              prep_feats_bucketed, nearest_hit_hybrid_feats,
                              kernel_order_dest)

``occluded_hybrid_feats`` is the any-hit (shadow) query on the same path,
``nearest_hit_conecull_checked`` the same closest hit through the phase-B
cone-cull walk (on ``prep_rays_bucketed`` rays), and
``nearest_hit_cull_checked`` through the 1024-ray packet cull;
scenes of many table chunks go through ``nearest_hit_tlas_feats`` (the
TLAS-routed path), typically over ``build_bvh_device``'s LBVH. Scenes and
trees are built on the CUDA device unless ``device`` names another.

The differentiable path: ``soft_render`` (dense soft model),
``soft_render_sparse`` and its packet forms over ``leaf_candidates``
(BVH-sparsified), ``fit_scene`` (inverse rendering; ``python -m
tracer_torch.cli fit``), ``refit_bvh`` and ``save_state``/``load_state``
(checkpoints in the JAX package's file layout).

The tooling: the BVH-against-brute-force sweep (``bench.harness.run_sweep``;
``python -m tracer_torch.cli bench``), ``bvh.flat.bvh_stats``, the
wireframe overlay (``viz``; ``python -m tracer_torch.cli viz``) and the
sanitizers (``debug``; ``TRACER_DEBUG=1``).

The distribution (``tracer_torch.dist``, on ``torch.distributed``):
``ray_mesh``/``scene_mesh``, the ray-sharded ``nearest_hit_sharded`` and
``render_sharded``, the ring over scene shards (``nearest_hit_ring``,
``build_sharded_bvh``), the sharded training step (``make_train_step``),
``fit_scene(mesh=..., grad_microbatch=...)`` and the scaling harness
(``measure_scaling``). ``nearest_hit_leafcull_t`` is the closest hit
straight from the leaf walk, without the HitRecord epilogue.

The renderer (``render``, ``render_direct``; ``python -m tracer_torch.cli
render``) takes any closest-hit intersector: the leaf walk
(``nearest_hit_leafcull_checked``), the packet walk
(``nearest_hit_bvh_packets``), the tile cull
(``nearest_hit_tilecull_checked``), the per-ray walk (``nearest_hit_bvh``)
or the dense sweep (``nearest_hit_brute_fast``).

On CUDA tensors the row compactor and the walks run as CUDA kernels built
with nvcc into ``build/tracer_torch/`` on first use; on CPU tensors they
run as their plain PyTorch versions.
"""

from tracer_torch.core.types import Ray, HitRecord
from tracer_torch.scene.scene import (Scene, fixed_scene, random_scene,
                                      benchmark_scene)
from tracer_torch.intersect.sphere import (EPSILON, ray_sphere_t,
                                           hit_record_from_t)
from tracer_torch.intersect.brute import (nearest_hit_brute, any_hit_brute,
                                          brute_t_fast,
                                          nearest_hit_brute_fast)
from tracer_torch.bvh.flat import FlatBVH, padded_scene_arrays, validate_bvh
from tracer_torch.bvh.builder import build_bvh
from tracer_torch.bvh.device import build_bvh_device, morton_codes_3d
from tracer_torch.interop import (scene_from_numpy, flat_bvh_from_numpy,
                                  camera_from_numpy)
from tracer_torch.config import TracerConfig
from tracer_torch.scene.camera import Camera, camera_rays
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
                                           occluded_hybrid_feats,
                                           conecull_call,
                                           nearest_hit_conecull_t,
                                           nearest_hit_conecull,
                                           nearest_hit_conecull_checked,
                                           nearest_hit_hybrid_t)
from tracer_torch.core.sort import (prep_rays_bucketed, sort_rays_octahedral,
                                    sort_rays_by_direction)
from tracer_torch.kernels.tlas import (route_pairs, tlas_candidates,
                                       routed_call, nearest_hit_tlas_feats)
from tracer_torch.kernels.leafcull import (nearest_hit_leafcull,
                                           nearest_hit_leafcull_checked,
                                           nearest_hit_leafcull_t,
                                           occluded_leafcull,
                                           occluded_leafcull_checked)
from tracer_torch.intersect.traverse import nearest_hit_bvh
from tracer_torch.intersect.cull import (LeafTable, build_leaf_table,
                                         tile_candidates)
from tracer_torch.kernels.traverse import (PackedBVH, pack_bvh,
                                           traverse_call,
                                           nearest_hit_bvh_packets)
from tracer_torch.kernels.tilecull import (tilecull_call,
                                           nearest_hit_tilecull,
                                           nearest_hit_tilecull_checked)
from tracer_torch.kernels.cull import (cull_call, nearest_hit_cull,
                                       nearest_hit_cull_checked)
from tracer_torch.integrator.wavefront import (Accumulator, bounce_noise,
                                               render, render_direct,
                                               sky_color, trace_direct,
                                               trace_radiance)
from tracer_torch.kernels.leafcull import leaf_candidates
from tracer_torch.diff.soft import SoftParams, soft_render
from tracer_torch.diff.sparse import (soft_radius_scale, soft_render_sparse,
                                      soft_render_sparse_leaforder)
from tracer_torch.diff.fit import FitResult, fit_scene
from tracer_torch.bvh.refit import RefitPlan, build_refit_plan, refit_bvh
from tracer_torch.checkpoint import load_state, save_state
from tracer_torch.dist import (RAY_AXIS, SCENE_AXIS, AdamState, ShardedBVH,
                               build_sharded_bvh, init_distributed,
                               make_train_step, nearest_hit_ring,
                               nearest_hit_sharded, ray_mesh, render_sharded,
                               scene_mesh)
from tracer_torch.bench.scaling import measure_scaling

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
    "nearest_hit_brute_fast", "camera_from_numpy", "TracerConfig", "Camera",
    "camera_rays", "nearest_hit_leafcull", "nearest_hit_leafcull_checked",
    "occluded_leafcull", "occluded_leafcull_checked", "nearest_hit_bvh",
    "LeafTable", "build_leaf_table", "PackedBVH", "pack_bvh",
    "traverse_call", "nearest_hit_bvh_packets", "tilecull_call",
    "nearest_hit_tilecull", "nearest_hit_tilecull_checked", "Accumulator",
    "bounce_noise", "render", "render_direct", "sky_color", "trace_direct",
    "trace_radiance", "conecull_call", "nearest_hit_conecull_t",
    "nearest_hit_conecull", "nearest_hit_conecull_checked",
    "nearest_hit_hybrid_t", "prep_rays_bucketed", "sort_rays_octahedral",
    "sort_rays_by_direction", "tile_candidates", "cull_call",
    "nearest_hit_cull", "nearest_hit_cull_checked", "leaf_candidates",
    "SoftParams", "soft_render", "soft_radius_scale", "soft_render_sparse",
    "soft_render_sparse_leaforder", "FitResult", "fit_scene", "RefitPlan",
    "build_refit_plan", "refit_bvh", "load_state", "save_state",
    "nearest_hit_leafcull_t", "RAY_AXIS", "SCENE_AXIS", "init_distributed",
    "ray_mesh", "scene_mesh", "nearest_hit_sharded", "render_sharded",
    "nearest_hit_ring", "ShardedBVH", "build_sharded_bvh", "AdamState",
    "make_train_step", "measure_scaling",
]
