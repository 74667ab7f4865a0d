"""The rays that escalation walks again, over the rays that a direct
frame's closest-hit and shadow calls were asked: the counters
``escalated_rays`` of the spans ``tracer_torch.escalate`` (retries of
either query) over ``rays`` of the spans ``tracer_torch.nearest`` and
``tracer_torch.occluded`` (each counted once a call), summed over the
frame; the median over the traced frames. 0 where nothing escalated; None
where no call counted its rays, or where an escalation counted no rays."""

from benchmark import program_trace as pt


def read(rec):
    rs = pt.roots("render")
    if rs is None:
        return None
    out = []
    for r in rs:
        retries = pt.spans(r, "escalate")
        if any("escalated_rays" not in s["counters"] for s in retries):
            return None
        asked = [pt.total(r, layer, "rays")
                 for layer in ("nearest", "occluded")]
        if any(asked):
            out.append((pt.total(r, "escalate", "escalated_rays") or 0)
                       / sum(a or 0 for a in asked))
    return pt.median(out)
