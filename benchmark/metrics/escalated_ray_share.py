"""The rays that escalation walks again, over the rays the closest-hit
calls were asked: the counters ``escalated_rays`` of the spans
``tracer_torch.escalate`` (each retry of a checked call walks all of its
rays again) over ``rays`` of the calls (``tracer_torch.nearest``, counted
once a call), summed over a frame (or a query); the median over the traced
roots. 0 where nothing escalated; None where no call counted its rays, or
where an escalation counted no rays (a program without the counter)."""

from benchmark import program_trace as pt


def read(rec):
    rs = pt.roots("render") or pt.roots("nearest")
    if rs is None:
        return None
    out = []
    for r in rs:
        retries = pt.spans(r, "escalate")
        if any("escalated_rays" not in s["counters"] for s in retries):
            return None
        asked = pt.total(r, "nearest", "rays")
        if asked:
            out.append((pt.total(r, "escalate", "escalated_rays") or 0)
                       / asked)
    return pt.median(out)
