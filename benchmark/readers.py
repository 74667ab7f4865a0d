"""What the metric readers share. Each reader takes the run's record
(``harness.run_cell``): ``setup_s``; ``window`` (seconds, requests, work,
failed, latencies_s); ``spans`` (name -> ms of each request, traced runs);
``device`` (the profiled requests' summary, traced runs on the card, with
``ranges``, the device operations by the span they were launched in). A
reader that finds nothing to read returns None, and the metric is left out
of the line."""

from __future__ import annotations

from benchmark.kernels import in_group


def per_request_ms(rec: dict) -> float | None:
    w = rec["window"]
    return w["seconds"] * 1e3 / w["requests"] if w["requests"] else None


def percentile_ms(rec: dict, q: float) -> float | None:
    """The q-th percentile (linear between order statistics) of every
    request's latency in the window."""
    lat = sorted(rec["window"]["latencies_s"])
    if not lat:
        return None
    x = (len(lat) - 1) * q / 100.0
    i = int(x)
    j = min(i + 1, len(lat) - 1)
    return (lat[i] + (lat[j] - lat[i]) * (x - i)) * 1e3


def span_ms(rec: dict, name: str) -> float | None:
    """Mean milliseconds of the span ``name`` over the window's requests."""
    v = rec["spans"].get(name)
    return sum(v) / len(v) if v else None


def _profiled(rec: dict):
    dev = rec.get("device")
    if not dev or not dev["requests"] or dev["busy_s"] <= 0:
        return None
    return dev


def device_ms(rec: dict, group) -> float | None:
    """Device milliseconds a profiled request in the kernels of
    ``group``; None where no such kernel ran."""
    dev = _profiled(rec)
    if dev is None:
        return None
    hits = [s for name, (s, _) in dev["ops"].items() if in_group(name, group)]
    return sum(hits) * 1e3 / dev["requests"] if hits else None


def range_device_ms(rec: dict, span: str, without=()) -> float | None:
    """Device milliseconds a profiled request in the operations launched
    inside the span ``span``, those of the group ``without`` left out;
    None where no such operation ran."""
    dev = _profiled(rec)
    if dev is None:
        return None
    ops = dev.get("ranges", {}).get(span, {})
    hits = [s for name, (s, _) in ops.items() if not in_group(name, without)]
    return sum(hits) * 1e3 / dev["requests"] if hits else None


def launches(rec: dict) -> float | None:
    dev = _profiled(rec)
    return None if dev is None else dev["launches"] / dev["requests"]


def idle_share(rec: dict) -> float | None:
    """The share of the profiled window in which no device operation ran."""
    dev = _profiled(rec)
    return None if dev is None else 1.0 - dev["busy_s"] / dev["window_s"]
