"""The share of phase A's (subpacket, chunk) rows that fell back to group
mode (count < 0) in a frame: the counters ``group_rows`` over ``rows`` of
every ``tracer_torch.phase_a`` span of the frame (each closest-hit call of
each bounce, and each escalation's retry), summed over the frame; the
median over the traced frames."""

from benchmark import program_trace as pt


def read(rec):
    return pt.ratio_median("render", "phase_a", "group_rows", "rows")
