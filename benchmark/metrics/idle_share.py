"""The share of the profiled requests' window in which no device operation
ran."""

from benchmark import readers


def read(rec):
    return readers.idle_share(rec)
