"""What the drivers share: the port's scene and trees built from the
benchmark's inputs, freeing, the control's dtype."""

from __future__ import annotations

import gc

import torch

from benchmark.timing import Spans

NO_SPANS = Spans(torch.device("cpu"), on=False)


def scene(st):
    """The port's Scene over the benchmark's sphere tensors."""
    from tracer_torch.scene.scene import Scene
    return Scene(centers=st.centers, radii=st.radii, albedo=st.albedo)


def bvh(st, leaf_size: int | None = None):
    """The configuration's tree: the native SAH builder or the device
    LBVH, at its leaf size."""
    b = st.cfg["bvh"]
    ls = int(leaf_size or b["leaf_size"])
    if b["builder"] == "native_sah":
        from tracer_torch.bvh.builder import build_bvh
        return build_bvh(st.centers, st.radii, leaf_size=ls,
                         backend="native", device=st.device)
    if b["builder"] == "device_lbvh":
        from tracer_torch.bvh.device import build_bvh_device
        return build_bvh_device(st.centers, st.radii, leaf_size=ls)
    raise ValueError(f"unknown builder {b['builder']!r}")


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def dtype(name: str) -> torch.dtype:
    """The control's dtype by name (``bfloat16``)."""
    return getattr(torch, name)
