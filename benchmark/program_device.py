"""What the readers of the program's own device counters share.

``tracer_torch.trace`` counts, on each span of a root, the host syncs
made inside it (``syncs``; every root carries it, 0 where none happened)
and the launches of the port's hand-written kernels with their device
time between two timing events on the launch's stream (``kernels``,
``kernel_ns``); a read of the device on purpose is a span of its own,
``tracer_torch.sync``. Where the stream is idle at a launch, its event
pair also holds the launch's host latency (10 to 20 us on an H100), so
``kernel_ns`` is read only for spans whose kernels run long against it:
the walks and the soft composite and backward, within 10 % of the
profiler's kernel time on the card. Prep, phase A and the compactor run
kernels of tens of us, which the pair reads 1.3 to 13 times too long:
they have no reader here. A reader takes a quantity per root, the median
over the traced roots of each name, and sums those medians over the
names that make one request: a query is ``prep`` and ``nearest``, a frame
``render``, an inverse-rendering evaluation ``soft``. Where the program
has no trace module, kept no such root, or counted no such counter (as a
program without these counters), it returns None.
"""

from __future__ import annotations

from benchmark import program_trace as pt

REQUEST = ("prep", "nearest", "render", "soft")


def per_request(value) -> float | None:
    """``value(root)`` (a number, or None), the median over the kept
    roots of each name of :data:`REQUEST`, summed over the names; None
    where no root gave a number."""
    out = None
    for layer in REQUEST:
        rs = pt.roots(layer)
        if rs is None:
            continue
        m = pt.median(value(r) for r in rs)
        if m is not None:
            out = (out or 0.0) + m
    return out


def _under(root: dict, span: dict, layer: str) -> bool:
    """Whether ``span`` lies inside a span named ``tracer_torch.<layer>``
    of ``root``."""
    by_id = {s["id"]: s for s in root["spans"]}
    parent = span["parent"]
    while parent is not None:
        up = by_id[parent]
        if up["name"] == "tracer_torch." + layer:
            return True
        parent = up["parent"]
    return False


def kernel_ms(layers, under: str | None = None):
    """A reader's quantity: device milliseconds of the port's kernels
    launched directly inside the root's spans named in ``layers`` (those
    inside a span named ``under``, where given), from ``kernel_ns``; None
    where none of them counted it."""
    def value(root: dict) -> float | None:
        vals = [s["counters"]["kernel_ns"] for s in root["spans"]
                if s["name"][len("tracer_torch."):] in layers
                and "kernel_ns" in s["counters"]
                and (under is None or _under(root, s, under))]
        return sum(vals) / 1e6 if vals else None
    return value


def syncs(root: dict) -> float | None:
    """Host syncs of the root: ``syncs`` summed over its spans; None
    where the root does not carry the counter."""
    if "syncs" not in root["counters"]:
        return None
    return float(sum(s["counters"].get("syncs", 0) for s in root["spans"]))


def wait_ms(root: dict) -> float | None:
    """Host milliseconds of the root's ``sync`` spans (0.0 where it has
    none); None where the root does not carry ``syncs``."""
    if "syncs" not in root["counters"]:
        return None
    return sum(pt.host_ms(s) for s in pt.spans(root, "sync"))
