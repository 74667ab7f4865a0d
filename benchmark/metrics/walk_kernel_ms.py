"""Device milliseconds of a request's walks, timed inside the program:
``kernel_ns`` of the spans ``tracer_torch.walk`` (every hand-written
launch made directly inside them, each between two timing events on its
stream), summed over the root; the median over the traced roots of each
name, summed over the names of a request. None where no walk counted it
(the CPU, or a program without the counter). The event pair
also holds a launch's host latency where the stream is idle (10 to 20
us), a few per cent of these kernels' time (``program_device``)."""

from benchmark import program_device as pd


def read(rec):
    return pd.per_request(pd.kernel_ms(("walk",)))
