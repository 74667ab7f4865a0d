"""The share of the wavefront's slots that hold live paths after the
primary bounce: the counters ``live_rays`` over ``slots`` of the spans
``tracer_torch.bounce`` 1 and up, summed over a frame; the median over
the traced frames."""

from benchmark import program_trace as pt


def read(rec):
    return pt.ratio_median("render", "bounce", "live_rays", "slots",
                           keep=lambda s: s["arg"] >= 1)
