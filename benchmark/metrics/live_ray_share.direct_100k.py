"""The share of the shadow query's slots that hold live rays, the hit
pixels whose shadow rays are walked: the counters ``live_rays`` over
``slots`` of the span ``tracer_torch.shadow`` of a direct frame; the
median over the traced frames. None for a program without that span."""

from benchmark import program_trace as pt


def read(rec):
    return pt.ratio_median("render", "shadow", "live_rays", "slots")
