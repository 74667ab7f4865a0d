"""Device milliseconds a profiled query in the row compactor."""

from benchmark import kernels, readers


def read(rec):
    return readers.device_ms(rec, kernels.COMPACT)
