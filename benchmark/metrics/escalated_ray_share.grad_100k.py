"""The rays that phase A takes again, over the rays an inverse-rendering
evaluation was asked: the counters ``escalated_rays`` of the spans
``tracer_torch.escalate`` (each retry reruns phase A over every ray of the
evaluation; the composite runs once) over the counter ``rays`` of the root
``tracer_torch.soft``; the median over the traced evaluations. 0 where
nothing escalated; None without such roots, or where an escalation counted
no rays."""

from benchmark import program_trace as pt


def read(rec):
    rs = pt.roots("soft")
    if rs is None:
        return None
    out = []
    for r in rs:
        retries = pt.spans(r, "escalate")
        if any("escalated_rays" not in s["counters"] for s in retries):
            return None
        asked = r["counters"].get("rays")
        if asked:
            out.append((pt.total(r, "escalate", "escalated_rays") or 0)
                       / asked)
    return pt.median(out)
