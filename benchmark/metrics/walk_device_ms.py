"""Device milliseconds a profiled request in the walk kernels (the leaf
walk, the routed walk, or the packet walk)."""

from benchmark import kernels, readers


def read(rec):
    return readers.device_ms(rec, kernels.WALK)
