"""The share of the packet walk's packets that walked past its step cap,
which its resume launch walks: the counters ``resumed_packets`` over
``packets`` of a frame's spans ``tracer_torch.walk``; the median over the
traced frames."""

from benchmark import program_trace as pt


def read(rec):
    return pt.ratio_median("render", "walk", "resumed_packets", "packets")
