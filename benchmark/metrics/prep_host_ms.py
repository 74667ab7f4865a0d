"""Host milliseconds of prep (``leafcull.prep_feats_bucketed``) a query:
the span ``tracer_torch.prep`` from its start to its end on the host
clock, the issue of prep's launches; the median over the traced queries."""

from benchmark import program_trace as pt


def read(rec):
    rs = pt.roots("prep")
    return None if rs is None else pt.median(pt.host_ms(r) for r in rs)
