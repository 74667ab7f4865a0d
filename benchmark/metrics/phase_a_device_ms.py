"""Device milliseconds a profiled query in what the closest-hit call
launches besides the walk: phase A's candidate rows, TLAS routing and
routed phase A, the compactor, and the torch operations between them."""

from benchmark import kernels, readers


def read(rec):
    return readers.range_device_ms(rec, "nearest", without=kernels.WALK)
