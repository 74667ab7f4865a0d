"""Spans and counters at the boundaries of the port's layers.

A span is a ``torch.profiler`` user range named ``tracer_torch.<layer>``
around one call into a layer (prep, the closest-hit call, the shadow
call, phase A, routing, the compactor, a walk, a frame, a bounce, a
direct frame's shadow query, wavefront compaction, an escalation retry, a
soft evaluation and its blocks' composite and backward, a host wait), so
it sits on the profiler's clock beside the device operations it launched
and shows in ``render --profile``'s Chrome trace. The range carries the
span's id as its first input, and its argument, where it has one, as the
second: a profiler that records shapes (``record_shapes=True``) shows
them as the event's concrete inputs, an exact join with :func:`records`.
Each span is also kept in memory: its name, argument, id, start and end
(``time.time_ns``: Unix ns, the clock a profiler event's
``time_range`` is on once ``kineto_results.trace_start_ns()`` is added
back), the span that opened it, and the id of its root span, which every
span of one outermost call shares. A counter is taken inside the span
where the work happens: host ints, or device tensors that stay on the
device until :func:`records` reads them (after the caller's own
synchronise, so no counter adds a host sync). Counters that need a
reduction launch it inside a ``tracer_torch.count`` range
(:func:`counting`), so a trace reader can tell those launches from the
program's.

Two counters come from below the layers. ``syncs``: while a root is
open, torch's CUDA sync debug mode is "warn" and each warning it raises
(one a host sync: a read of a device value, a size known only on the
device) adds 1 to the innermost open span, and is kept from stderr; a
place that reads the device on purpose is the span ``tracer_torch.sync``,
its argument what is read, so its wait is timed and its sync counted
there. Every root carries ``syncs``, 0 where none happened. ``kernels``
and ``kernel_ns``: each launch of a hand-written kernel
(``kernels/_lib.launch``) adds 1 to ``kernels`` of the innermost open
span and the device time between two timing events recorded around it on
its stream to ``kernel_ns``; where the stream is idle the pair also
holds the launch's own host latency (10 to 20 us), so a kernel of a few
tens of us reads several times its device time, and only a span whose
kernels run long against that (the walks, the soft composite and
backward) reads its device time to a few per cent. The events are read
without a host sync: by :func:`records`, or at a later root's entry once
the device has passed them (``Event.query``), and then released.

The trace is on while a ``torch.profiler`` records (torch's flag
``torch.autograd.profiler._is_profiler_enabled``) and inside
:func:`enabled`. Off, a boundary, a launch and a host read each cost a
flag check: no allocation, no launch, no range, no event. The store keeps
the last ``ROOTS`` root spans of the process (one thread), read by
:func:`records` and emptied by :func:`reset`; it writes no file.

The checked (budget-doubling) queries and the checked soft evaluation
count their calls and escalations whether the trace is on or not
(:func:`checked`): into the open span, and into the dict of each open
:func:`tallied` scope.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import re
import time
import warnings
from collections import deque

import torch
from torch.autograd import profiler as _profiler

PREFIX = "tracer_torch."
ROOTS = 1000
# Timing events kept for reuse once read, and made at a time (each
# recorded once, so that its CUDA event exists before it times a launch).
EVENTS = 4096
EVENT_BATCH = 64
# The start of the warning torch raises at a host sync in the sync debug
# mode "warn" (``c10::cuda::warn_or_error_on_sync``).
SYNC_WARNING = "called a synchronizing CUDA operation"
# The warning torch raises once a process when the mode is first set.
_MODE_WARNING = "Synchronization debug mode is a prototype"
# The warning filters an open root puts first: every sync warning shown,
# the mode's notice not (the entries ``warnings.filterwarnings`` makes).
_FILTERS = [("always", re.compile(SYNC_WARNING, re.I), Warning, None, 0),
            ("ignore", re.compile(_MODE_WARNING, re.I), Warning, None, 0)]
_NULL = contextlib.nullcontext()


class _Store:
    """The process's spans: the open ones (innermost last), the last
    ``ROOTS`` finished roots, the depth of :func:`enabled`, the next id,
    the open tallies of the checked queries (innermost last), the roots
    whose kernel events are not read yet (oldest first), the state the
    open root's sync watch restores, the host syncs by (span name, file,
    line) of the Python line that made them, the timing events free for
    reuse, and the torch stream of each (device, raw stream)."""

    def __init__(self):
        self.stack: list[_Span] = []
        self.roots: deque = deque(maxlen=ROOTS)
        self.explicit = 0
        self.next_id = 0
        self.tallies: list[dict] = []
        self.pending: deque = deque()
        self.watch = None
        self.sync_sites: collections.Counter = collections.Counter()
        self.free: list = []
        self.streams: dict = {}


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


def _sync_mode(mode: int):
    """Set torch's CUDA sync debug mode to ``mode`` (0 off, 1 "warn")
    where CUDA is initialised, returning the mode it replaced; None
    elsewhere."""
    if not torch.cuda.is_initialized():
        return None
    old = torch._C._cuda_get_sync_debug_mode()
    torch._C._cuda_set_sync_debug_mode(mode)
    return old


def _seen(show, message, category, filename, lineno, file=None,
          line=None):
    """``warnings.showwarning`` while a root is open: a host sync's
    warning adds 1 to ``syncs`` of the innermost open span and to
    ``sync_sites``; any other goes on to ``show``."""
    stack = _store.stack
    if stack and str(message).startswith(SYNC_WARNING):
        stack[-1].add("syncs", 1)
        _store.sync_sites[(stack[-1].name, filename, lineno)] += 1
        return
    show(message, category, filename, lineno, file, line)


def _watch():
    """Count host syncs until :func:`_unwatch`: the sync debug mode
    "warn", and every sync warning shown (:data:`_FILTERS`, put before the
    process's filters) to :func:`_seen`. The filter list is swapped, not
    changed, so the version that once-per-location warnings are kept
    under does not move: a warning shown once before a root is not shown
    again after it."""
    filters, show = warnings.filters, warnings.showwarning
    warnings.filters = _FILTERS + filters
    warnings.showwarning = functools.partial(_seen, show)
    try:
        mode = _sync_mode(1)
    except BaseException:
        warnings.filters, warnings.showwarning = filters, show
        raise
    return filters, show, mode


def _unwatch(state) -> None:
    """Restore the sync debug mode, the warning filters and the display
    that :func:`_watch` replaced."""
    filters, show, mode = state
    try:
        if mode is not None:
            _sync_mode(mode)
    finally:
        warnings.filters, warnings.showwarning = filters, show


def _events(stream) -> tuple:
    """Two timing events for a launch on ``stream``: free ones, else a
    batch made (and recorded once on ``stream``)."""
    free = _store.free
    if len(free) < 2:
        for _ in range(EVENT_BATCH):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(stream)
            free.append(ev)
    return free.pop(), free.pop()


def launch_start(device: int, raw: int):
    """Before a launch of a hand-written kernel on CUDA device ``device``
    and its current stream ``raw`` (a ``cudaStream_t``): with a span
    open, its start event recorded (the end one ready), else None."""
    stack = _store.stack
    if not stack:
        return None
    streams = _store.streams
    stream = streams.get((device, raw))
    if stream is None:
        stream = streams[device, raw] = torch.cuda.current_stream(device)
    start, end = _events(stream)
    start.record(stream)
    return stack[-1], start, end, stream


def launch_end(started) -> None:
    """After the launch that :func:`launch_start` began (``started`` not
    None): its end event recorded, and 1 more ``kernels`` of the span it
    opened in; the pair is read into ``kernel_ns`` later, without a
    sync."""
    span, start, end, stream = started
    end.record(stream)
    span.add("kernels", 1)
    span.root._events.append((span, start, end))


def _read_events(root) -> None:
    """Add each of the root's event pairs to ``kernel_ns`` of the span it
    timed (ns, an int), and free the events for reuse."""
    events, root._events = root._events, []
    free = _store.free
    for span, start, end in events:
        span.add("kernel_ns", round(start.elapsed_time(end) * 1e6))
        if len(free) < EVENTS:
            free += (start, end)


def _read_passed() -> None:
    """Read the events of the oldest unread roots that the device has
    passed (their last event done, asked without blocking)."""
    pending = _store.pending
    while pending:
        root = pending[0]
        if root._events and not root._events[-1][2].query():
            return
        pending.popleft()
        _read_events(root)


class _Span:
    __slots__ = ("name", "arg", "id", "parent", "root", "start_ns", "end_ns",
                 "counters", "spans", "_range", "_allocs", "_events")

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
            self._events = []
            _read_passed()
            self._allocs = _allocs()
            self.counters["syncs"] = [0]
            st.watch = _watch()
        else:
            self.root.spans.append(self)
        args = (self.id,) if self.arg is None else (
            self.id, self.arg if isinstance(self.arg, int) else str(self.arg))
        self._range = torch.autograd._record_function_with_args_enter(
            self.name, *args)
        st.stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        st = _store
        st.stack.pop()
        try:
            torch.autograd._record_function_with_args_exit(self._range)
        finally:
            self._range = None
            if self.parent is None:
                watch, st.watch = st.watch, None
                _unwatch(watch)
                if self._allocs is not None:
                    self.add("device_allocs", _allocs() - self._allocs)
                st.roots.append(self)
                if self._events:
                    st.pending.append(self)
        return False

    def add(self, name: str, value) -> None:
        self.counters.setdefault(name, []).append(value)

    def record(self) -> dict:
        """The span as a dict, its counters summed into ints (device
        values and kernel events read here)."""
        if self.parent is None and self._events:
            _read_events(self)
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
    """One call of a checked ``kind`` query ("closest" or "shadow"), or of
    the checked soft evaluation ("soft",
    ``diff.sparse.soft_loss_grad_sparse``, whose phase A alone escalates),
    that escalated ``escalations`` times: always added to every open tally
    as ``<kind>_calls`` and ``<kind>_escalations``, and to the innermost
    open span as ``calls`` and ``escalations`` (the ``soft`` root for an
    evaluation)."""
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
    """Drop every kept root, its unread kernel events and the counts of
    ``sync_sites`` (the open spans and tallies stay)."""
    _store.roots.clear()
    _store.pending.clear()
    _store.sync_sites.clear()


def sync_sites() -> dict:
    """The host syncs counted since :func:`reset`, by (span name, file,
    line): the innermost open span and the Python line whose call
    synced."""
    return dict(_store.sync_sites)


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
