"""Host milliseconds of a frame inside the program: the span
``tracer_torch.render`` from its start to its end on the host clock (the
frame's issue, and every host sync inside it); the median over the traced
frames."""

from benchmark import program_trace as pt


def read(rec):
    rs = pt.roots("render")
    return None if rs is None else pt.median(pt.host_ms(r) for r in rs)
