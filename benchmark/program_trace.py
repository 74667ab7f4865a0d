"""What the readers of the program's own trace share.

``tracer_torch.trace`` keeps, in the process, a record of each outermost
call into the port (a root span) made while a profiler recorded: in a
traced run, the profiler's warm-up request and the window's first
``trace_requests`` requests. A query request is two roots,
``tracer_torch.prep`` and ``tracer_torch.nearest``; a frame is one,
``tracer_torch.render``. Each root lists its spans with their host
start and end and their counters. A reader takes a quantity per root and
the median over the roots, so the warm-up request cannot move it. Where
the program has no trace module, or kept no root of the name, it returns
None.
"""

from __future__ import annotations

import statistics


def roots(layer: str) -> list[dict] | None:
    """The kept roots named ``tracer_torch.<layer>``; None without the
    program's trace or without such a root."""
    try:
        from tracer_torch import trace
    except ImportError:
        return None
    out = [r for r in trace.records() if r["name"] == "tracer_torch." + layer]
    return out or None


def spans(root: dict, layer: str) -> list[dict]:
    return [s for s in root["spans"] if s["name"] == "tracer_torch." + layer]


def host_ms(span: dict) -> float:
    return (span["end_ns"] - span["start_ns"]) / 1e6


def total(root: dict, layer: str, counter: str, keep=None) -> int | None:
    """The counter summed over the root's spans of ``layer`` (those that
    ``keep`` accepts); None where none holds it."""
    vals = [s["counters"][counter] for s in spans(root, layer)
            if counter in s["counters"] and (keep is None or keep(s))]
    return sum(vals) if vals else None


def median(values) -> float | None:
    vals = [v for v in values if v is not None]
    return float(statistics.median(vals)) if vals else None


def ratio_median(layer: str, over: str, num: str, den: str,
                 keep=None) -> float | None:
    """The median over the roots ``layer`` of the counter ``num`` over
    ``den``, each summed over the root's spans of ``over``."""
    rs = roots(layer)
    if rs is None:
        return None
    out = []
    for r in rs:
        n, d = total(r, over, num, keep), total(r, over, den, keep)
        if n is not None and d:
            out.append(n / d)
    return median(out)
