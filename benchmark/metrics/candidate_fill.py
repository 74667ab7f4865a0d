"""The share of the soft composite's lanes that hold a real candidate: the
counters ``candidates`` (a (ray, sphere) pair of a candidate leaf's real
slot) over ``lanes`` (rays times candidate slots evaluated, each block as
wide as its widest subpacket) of the spans ``tracer_torch.composite``,
summed over a root ``tracer_torch.soft``; the median over the traced
evaluations. None without such spans."""

from benchmark import program_trace as pt


def read(rec):
    return pt.ratio_median("soft", "composite", "candidates", "lanes")
