"""The window's milliseconds over the frames completed in it."""

from benchmark import readers


def read(rec):
    return readers.per_request_ms(rec)
