"""The 95th percentile of every frame's time in the window, from its start
to its synchronise on the host clock."""

from benchmark import readers


def read(rec):
    return readers.percentile_ms(rec, 95.0)
