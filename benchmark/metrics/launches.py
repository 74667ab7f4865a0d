"""Device operations (kernels, copies, sets) a profiled request."""

from benchmark import readers


def read(rec):
    return readers.launches(rec)
