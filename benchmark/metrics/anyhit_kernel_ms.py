"""Device milliseconds of a direct frame's any-hit walks, timed inside
the program: ``kernel_ns`` of the spans ``tracer_torch.walk`` inside a
shadow call (``tracer_torch.occluded``), summed over the frame; the median
over the traced frames. None where no such walk counted it. The event pair
also holds a launch's host latency where the stream is idle (10 to 20
us), a few per cent of these kernels' time (``program_device``)."""

from benchmark import program_device as pd


def read(rec):
    return pd.per_request(pd.kernel_ms(("walk",), under="occluded"))
