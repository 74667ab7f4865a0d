"""The caching allocator's device allocations (``cudaMalloc``) a request
makes inside the program: the counter ``device_allocs`` of each root (the
change in ``num_device_alloc`` across it), the median over the traced
roots of each name, summed over the names (prep and the closest-hit call
for a query, the frame for a frame). None where no root counted it (no
card)."""

from benchmark import program_trace as pt


def read(rec):
    out = None
    for layer in ("prep", "nearest", "render"):
        rs = pt.roots(layer)
        if rs is None:
            continue
        m = pt.median(r["counters"].get("device_allocs") for r in rs)
        if m is not None:
            out = (out or 0.0) + m
    return out
