"""Host milliseconds of phase A an inverse-rendering evaluation: the spans
``tracer_torch.phase_a`` of each root ``tracer_torch.soft`` (one a try of
the escalation ladder, each with the read of its overflow, the ladder's
sync), summed, on the host clock; the median over the traced evaluations.
None for a program without the soft evaluation's root."""

from benchmark import program_trace as pt


def read(rec):
    rs = pt.roots("soft")
    if rs is None:
        return None
    return pt.median(sum(pt.host_ms(s) for s in pt.spans(r, "phase_a"))
                     if pt.spans(r, "phase_a") else None for r in rs)
