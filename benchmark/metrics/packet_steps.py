"""Nodes a packet of the packet walk visits: the counters ``packet_steps``
over ``packets`` of a frame's spans ``tracer_torch.walk``; the median over
the traced frames."""

from benchmark import program_trace as pt


def read(rec):
    return pt.ratio_median("render", "walk", "packet_steps", "packets")
