"""Frozen render configuration.

PyTorch counterpart of ``tracer/config.py``: every compile-time constant of
the reference becomes a field with the reference value as its default
(reference: ``include/Custom/constants.h:3-8``, ``src/main.c:18-19``).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TracerConfig:
    """Static render configuration (hashable).

    Defaults mirror the reference C tracer:
      - width/height: ``constants.h:7-8`` (800x600)
      - max_depth:    ``src/main.c:19`` (MAX_DEPTH 5)
      - epsilon:      ``constants.h:6`` (EPSILON 1e-6)
      - fov_degrees:  ``src/main.c:209`` (camera fov 45)
    """

    width: int = 800
    height: int = 600
    max_depth: int = 5
    epsilon: float = 1e-6
    fov_degrees: float = 45.0

    # Reference quirk: u is multiplied by the aspect ratio in the pixel loop
    # (src/main.c:362) *and* half_width = aspect * half_height inside
    # get_camera_ray (src/ray.c:21-23), so the aspect ratio is applied twice.
    # True  -> replicate the quirk (needed for image parity with the reference)
    # False -> correct pinhole model (aspect applied once)
    double_aspect_compat: bool = True

    # BVH build parameters: 8 candidate planes per axis (src/bvh.c:143-160),
    # depth cap 40 (src/bvh.c:131), leaves of up to bvh_leaf_size spheres.
    bvh_bins: int = 8
    bvh_max_depth: int = 40
    bvh_leaf_size: int = 4

    @property
    def aspect_ratio(self) -> float:
        return float(self.width) / float(self.height)


DEFAULT_CONFIG = TracerConfig()
