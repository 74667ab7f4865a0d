"""Host milliseconds of a frame's shadow calls: the spans
``tracer_torch.occluded`` (the checked any-hit query, its escalation
retries inside it) from start to end on the host clock, summed over the
frame; the median over the traced frames. None where no frame made a
shadow call through the checked driver (the dense oracle has no span)."""

from benchmark import program_trace as pt


def read(rec):
    rs = pt.roots("render")
    if rs is None:
        return None
    return pt.median(sum(pt.host_ms(s) for s in pt.spans(r, "occluded"))
                     if pt.spans(r, "occluded") else None for r in rs)
