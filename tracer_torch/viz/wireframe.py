"""BVH wireframe overlay: depth-coloured AABB edges drawn over a render.

PyTorch counterpart of ``tracer/viz/wireframe.py``. The reference's debug
visualiser (src/bvh_visualiser.c) projects with a camera model of its own
that disagrees with its ray generation, so its boxes miss the spheres.
Here the projection is the exact inverse of
``tracer_torch.scene.camera.camera_rays``: the same basis and the same
half width and height, the double-aspect quirk included, so the overlay
registers with the image. Host numpy: a debug path, not a hot path.
"""

from __future__ import annotations

import numpy as np

from tracer_torch.bvh.flat import node_depths
from tracer_torch.config import DEFAULT_CONFIG, TracerConfig
from tracer_torch.scene.camera import Camera

# The 12 edges of a box as index pairs into its 8 corners.
_EDGES = [(0, 1), (1, 3), (3, 2), (2, 0),
          (4, 5), (5, 7), (7, 6), (6, 4),
          (0, 4), (1, 5), (2, 6), (3, 7)]


def project_points(points: np.ndarray, camera: Camera,
                   config: TracerConfig = DEFAULT_CONFIG):
    """World points (..., 3) -> (x_px, y_px, in_front), inverting
    ``camera_rays``' pixel -> direction map (src/ray.c:17-32,
    src/main.c:362-365)."""
    f, r, u = (v.detach().cpu().numpy() for v in camera.basis())
    pos = camera.position.detach().cpu().numpy()
    fov_rad = float(camera.fov) * np.pi / 180.0
    half_h = np.tan(fov_rad / 2.0)
    half_w = config.aspect_ratio * half_h

    v = np.asarray(points) - pos
    a = v @ r
    b = v @ u
    c = v @ f
    in_front = c > 1e-6
    c_safe = np.where(in_front, c, 1.0)
    uu = a / (c_safe * 2.0 * half_w)
    vv = b / (c_safe * 2.0 * half_h)
    if config.double_aspect_compat:
        uu = uu / config.aspect_ratio
    x = (uu + 0.5) * config.width
    y = (0.5 - vv) * config.height
    return x, y, in_front


def draw_line(img: np.ndarray, x0, y0, x1, y1, color) -> None:
    """Sampled line from (x0, y0) to (x1, y1) into ``img`` (H, W, 3), in
    place; samples off the image are dropped."""
    h, w = img.shape[:2]
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) + 1
    xs = np.linspace(x0, x1, n).astype(int)
    ys = np.linspace(y0, y1, n).astype(int)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = color


def depth_color(depth: int, max_depth: int) -> np.ndarray:
    """Depth-keyed colour ramp (the reference colours by depth too,
    src/bvh_visualiser.c:103-106): red at the root, blue at the leaves."""
    t = min(depth / max(max_depth, 1), 1.0)
    return np.array([1.0 - t, 0.2 + 0.6 * abs(0.5 - t), t], np.float32)


def draw_bvh_wireframe(image: np.ndarray, bvh, camera: Camera,
                       config: TracerConfig = DEFAULT_CONFIG,
                       max_draw_depth: int = 8) -> np.ndarray:
    """Overlay the boxes of the nodes down to ``max_draw_depth`` on
    ``image`` (H, W, 3 float in [0, 1]); returns a copy."""
    img = np.array(image, np.float32, copy=True)
    node_min = bvh.node_min.cpu().numpy()
    node_max = bvh.node_max.cpu().numpy()
    depths = node_depths(bvh.escape.cpu().numpy())
    for i in np.flatnonzero(depths <= max_draw_depth):
        lo, hi = node_min[i], node_max[i]
        corners = np.array([[lo[0], lo[1], lo[2]],
                            [hi[0], lo[1], lo[2]],
                            [lo[0], hi[1], lo[2]],
                            [hi[0], hi[1], lo[2]],
                            [lo[0], lo[1], hi[2]],
                            [hi[0], lo[1], hi[2]],
                            [lo[0], hi[1], hi[2]],
                            [hi[0], hi[1], hi[2]]], np.float32)
        x, y, ok = project_points(corners, camera, config)
        color = depth_color(int(depths[i]), max_draw_depth)
        for a, b in _EDGES:
            if ok[a] and ok[b]:
                draw_line(img, x[a], y[a], x[b], y[b], color)
    return np.clip(img, 0.0, 1.0)
