from tracer_torch.viz.wireframe import draw_bvh_wireframe, project_points

__all__ = ["project_points", "draw_bvh_wireframe"]
