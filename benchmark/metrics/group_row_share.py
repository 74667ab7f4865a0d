"""The share of phase A's (subpacket, chunk) rows that fell back to group
mode (count < 0), which the walk then walks group by group: the counters
``group_rows`` over ``rows`` of each closest-hit call's phase A; the
median over the traced queries."""

from benchmark import program_trace as pt


def read(rec):
    return pt.ratio_median("nearest", "phase_a", "group_rows", "rows")
