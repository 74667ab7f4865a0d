"""Spans and counters at the boundaries of the port's layers.

A span is a ``torch.profiler.record_function`` range named
``tracer_torch.<layer>`` around one call into a layer (prep, the
closest-hit call, the shadow call, phase A, routing, the compactor, a
walk, a frame, a bounce, a direct frame's shadow query, wavefront
compaction, an escalation retry), so it sits on the profiler's clock
beside the device operations it launched and shows in ``render
--profile``'s Chrome trace. Each span is also kept
in memory: its name, argument, host start and end
(``time.perf_counter_ns``), the span that opened it, and the id of its
root span, which every span of one outermost call shares. A counter is taken inside the span where the
work happens: host ints, or device tensors that stay on the device until
:func:`records` reads them (after the caller's own synchronise, so no
counter adds a host sync). Counters that need a reduction launch it
inside a ``tracer_torch.count`` range (:func:`counting`), so a trace
reader can tell those launches from the program's.

The trace is on while a ``torch.profiler`` records (torch's flag
``torch.autograd.profiler._is_profiler_enabled``) and inside
:func:`enabled`. Off, a boundary costs a flag check: no allocation, no
launch, no ``record_function``. The store keeps the last ``ROOTS`` root
spans of the process (one thread), read by :func:`records` and emptied
by :func:`reset`; it writes no file.

The checked (budget-doubling) queries count their calls and escalations
whether the trace is on or not (:func:`checked`): into the open span, and
into the dict of each open :func:`tallied` scope.
"""

from __future__ import annotations

import contextlib
import functools
import time
from collections import deque

import torch
from torch.autograd import profiler as _profiler

PREFIX = "tracer_torch."
ROOTS = 1000
_NULL = contextlib.nullcontext()


class _Store:
    """The process's spans: the open ones (innermost last), the last
    ``ROOTS`` finished roots, the depth of :func:`enabled`, the next id,
    and the open tallies of the checked queries (innermost last)."""

    def __init__(self):
        self.stack: list[_Span] = []
        self.roots: deque = deque(maxlen=ROOTS)
        self.explicit = 0
        self.next_id = 0
        self.tallies: list[dict] = []


_store = _Store()


def on() -> bool:
    """Whether the boundaries record: a profiler is recording, or inside
    :func:`enabled`."""
    return bool(_store.explicit or _profiler._is_profiler_enabled)


def _allocs():
    """The caching allocator's device allocations so far, where CUDA is
    initialised; else None."""
    if not torch.cuda.is_initialized():
        return None
    return torch.cuda.memory_stats_as_nested_dict().get("num_device_alloc")


class _Span:
    __slots__ = ("name", "arg", "id", "parent", "root", "start_ns", "end_ns",
                 "counters", "spans", "_range", "_allocs")

    def __init__(self, name: str, arg=None):
        self.name = PREFIX + name
        self.arg = arg

    def __enter__(self):
        st = _store
        self.id = st.next_id
        st.next_id += 1
        self.parent = st.stack[-1] if st.stack else None
        self.root = self if self.parent is None else self.parent.root
        self.counters: dict[str, list] = {}
        if self.parent is None:
            self.spans = [self]
            self._allocs = _allocs()
        else:
            self.root.spans.append(self)
        self._range = _profiler.record_function(
            self.name, None if self.arg is None else str(self.arg))
        self._range.__enter__()
        st.stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        _store.stack.pop()
        self._range.__exit__(*exc)
        self._range = None
        if self.parent is None:
            if self._allocs is not None:
                self.add("device_allocs", _allocs() - self._allocs)
            _store.roots.append(self)
        return False

    def add(self, name: str, value) -> None:
        self.counters.setdefault(name, []).append(value)

    def record(self) -> dict:
        """The span as a dict, its counters summed into ints (device
        values read here)."""
        for k, vals in self.counters.items():
            if len(vals) != 1 or isinstance(vals[0], torch.Tensor):
                self.counters[k] = [sum(int(v) for v in vals)]
        return {"name": self.name, "arg": self.arg, "id": self.id,
                "parent": None if self.parent is None else self.parent.id,
                "root": self.root.id, "start_ns": self.start_ns,
                "end_ns": self.end_ns,
                "counters": {k: v[0] for k, v in self.counters.items()}}


def span(layer: str, arg=None):
    """A context around one call into ``layer``: the span
    ``tracer_torch.<layer>`` (with ``arg``, e.g. a bounce's index) when
    the trace is on, else a shared no-op context."""
    if not (_store.explicit or _profiler._is_profiler_enabled):
        return _NULL
    return _Span(layer, arg)


def spanned(layer: str):
    """Decorate a function so each call is the span ``tracer_torch.<layer>``
    when the trace is on; off, the call goes straight through."""
    def deco(fn):
        store, prof = _store, _profiler

        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not (store.explicit or prof._is_profiler_enabled):
                return fn(*args, **kwargs)
            with _Span(layer):
                return fn(*args, **kwargs)
        return run
    return deco


def count(**values) -> None:
    """Add each value (a host int, or a device tensor read later) to the
    counter of that name in the innermost open span; nothing when no span
    is open (the trace off)."""
    stack = _store.stack
    if stack:
        for k, v in values.items():
            stack[-1].add(k, v)


def count_outermost(**values) -> None:
    """:func:`count`, where no enclosing span has the innermost span's
    name: a closest-hit call made inside another (a checked driver's
    tries) adds its rays to the outer call's only."""
    stack = _store.stack
    if stack and all(s.name != stack[-1].name for s in stack[:-1]):
        count(**values)


def counting():
    """The ``tracer_torch.count`` range around a counter's own launches;
    enter it only where :func:`on` holds."""
    return _profiler.record_function(PREFIX + "count")


def checked(kind: str, escalations: int) -> None:
    """One call of a checked ``kind`` query ("closest" or "shadow") that
    escalated ``escalations`` times: always added to every open tally as
    ``<kind>_calls`` and ``<kind>_escalations``, and to the innermost open
    span as ``calls`` and ``escalations``."""
    for t in _store.tallies:
        t[f"{kind}_calls"] = t.get(f"{kind}_calls", 0) + 1
        t[f"{kind}_escalations"] = t.get(f"{kind}_escalations", 0) \
            + escalations
    count(calls=1, escalations=escalations)


def tallied(counts: dict, query):
    """``query``, a checked query returning (result, escalations), as a
    function returning the result that adds the calls and escalations of
    the checked queries it makes to ``counts`` (:func:`checked`)."""
    def run(*args):
        _store.tallies.append(counts)
        try:
            return query(*args)[0]
        finally:
            _store.tallies.pop()
    return run


@contextlib.contextmanager
def enabled():
    """Turn the trace on inside, with or without a profiler."""
    _store.explicit += 1
    try:
        yield
    finally:
        _store.explicit -= 1


def records() -> list[dict]:
    """The kept roots, oldest first: each the root span's dict (``name``,
    ``arg``, ``id``, ``parent`` None, ``root``, ``start_ns``, ``end_ns``,
    ``counters``) with ``spans``, every span of the root in the order
    they opened, the root first. Reads the device counters: call after
    the work's synchronise."""
    out = []
    for root in list(_store.roots):
        rec = root.record()
        rec["spans"] = [rec] + [s.record() for s in root.spans[1:]]
        out.append(rec)
    return out


def reset() -> None:
    """Drop every kept root (the open spans and tallies stay)."""
    _store.roots.clear()


def summary(recs: list[dict]) -> dict:
    """Roots, and each counter summed over the spans of ``recs`` by span
    name: {"roots": n, "counters": {span: {counter: total}}}."""
    out: dict[str, dict] = {}
    for rec in recs:
        for s in rec["spans"]:
            c = out.setdefault(s["name"], {})
            for k, v in s["counters"].items():
                c[k] = c.get(k, 0) + v
    return {"roots": len(recs),
            "counters": {k: v for k, v in out.items() if v}}
