"""The caching allocator's device allocations (``cudaMalloc``) an
inverse-rendering evaluation makes: the counter ``device_allocs`` of each
root ``tracer_torch.soft``; the median over the traced evaluations. None
where no root counted it (no card, or no such root)."""

from benchmark import program_trace as pt


def read(rec):
    rs = pt.roots("soft")
    if rs is None:
        return None
    return pt.median(r["counters"].get("device_allocs") for r in rs)
