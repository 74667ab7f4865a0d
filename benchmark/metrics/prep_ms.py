"""CUDA-event milliseconds of prep (sort, bucket pad, features, result
order) a query, over the window."""

from benchmark import readers


def read(rec):
    return readers.span_ms(rec, "prep")
