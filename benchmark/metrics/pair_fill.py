"""The (chunk, g-block) pairs routing asked for over its budget
``npairs``: the counters ``pairs`` over ``pair_budget`` of the span
``tracer_torch.route``; above 1 the query overflows. The median over the
traced queries; None where the query is not routed."""

from benchmark import program_trace as pt


def read(rec):
    return pt.ratio_median("nearest", "route", "pairs", "pair_budget")
