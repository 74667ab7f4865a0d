"""Device milliseconds of an inverse-rendering evaluation's composite and
backward kernels, timed inside the program: ``kernel_ns`` of the spans
``tracer_torch.composite`` and ``tracer_torch.backward`` (``soft_cuda``'s
launches), summed over the evaluation; the median over the traced
evaluations. None where no block counted it. The event pair
also holds a launch's host latency where the stream is idle (10 to 20
us), a few per cent of these kernels' time (``program_device``)."""

from benchmark import program_device as pd


def read(rec):
    return pd.per_request(pd.kernel_ms(("composite", "backward")))
