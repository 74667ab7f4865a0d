"""Host milliseconds of phase A a query: the spans ``tracer_torch.phase_a``
(``cone_candidates``, or ``tlas_candidates`` with routing) of each
closest-hit call, summed, on the host clock; the median over the traced
queries."""

from benchmark import program_trace as pt


def read(rec):
    rs = pt.roots("nearest")
    if rs is None:
        return None
    return pt.median(sum(pt.host_ms(s) for s in pt.spans(r, "phase_a"))
                     if pt.spans(r, "phase_a") else None for r in rs)
