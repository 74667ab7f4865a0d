"""The trace's clock, ids, host syncs and kernel times on the CPU.

A span's ``record_function`` range carries its id (and its argument), so
under a profiler that records shapes each kept span is exactly one
``tracer_torch.*`` event, and its ``start_ns`` and ``end_ns`` lie on the
profiler's clock (Unix ns; the event's time plus ``trace_start_ns()``).
What only a card gives is stood in for: the warning torch's sync debug
mode raises at a host sync (``syncs`` of the innermost open span, the
``sync`` spans, nothing shown), the mode itself (set while a root is open
and restored after it, also after a root that raises, with the warning
filters and display), and the kernel library and timing events behind
``_lib.launch`` (``kernels``, ``kernel_ns``, the events read without a
sync and released).
"""

import collections
import contextlib
import warnings

import numpy as np
import pytest
import torch

import tracer_torch as tt
from tests.torch_parity import one_thread  # noqa: F401
from tracer_torch import trace
from tracer_torch.kernels import _lib
from tracer_torch.kernels.conecull import nearest_hit_hybrid_feats

S, SP, CELL_BITS = 8, 64, 4
# The profiler's events and the spans' stamps are taken a few calls apart.
CLOCK_NS = 100_000


@pytest.fixture(autouse=True)
def clean_store():
    trace.reset()
    yield
    trace.reset()


@pytest.fixture(scope="module")
def query():
    """A closest-hit query (``prep_feats_bucketed`` then
    ``nearest_hit_hybrid_feats``) over 2,000 spheres and 2,048 origin
    rays: two roots, their phase A, compactions and walk."""
    rng = np.random.default_rng(1)
    c = torch.as_tensor(rng.uniform(-40, 40, (2000, 3)).astype(np.float32))
    scene = tt.Scene(centers=c, radii=torch.full((2000,), 0.5),
                     albedo=torch.full((2000, 3), 0.5))
    tables = tt.build_cone_tables(scene, tt.build_bvh(
        scene.centers, scene.radii, leaf_size=32, device="cpu"))
    d = rng.uniform(-1, 1, (2048, 3)).astype(np.float32)
    d = torch.as_tensor(d / np.linalg.norm(d, axis=1, keepdims=True))

    def run():
        feats, dest = tt.prep_feats_bucketed(torch.zeros_like(d), d, S, SP,
                                             cell_bits=CELL_BITS)
        return (dest, *nearest_hit_hybrid_feats(feats, tables, 64, 8))
    return run


def test_spans_join_the_profilers_events_by_id_and_clock(query):
    from torch.profiler import ProfilerActivity, profile
    # A first profiled pass takes the profiler's and the ranges' one-time
    # set-up.
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True):
        query()
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        with trace.span("bounce", 3):
            pass
        query()
    start = prof.profiler.kineto_results.trace_start_ns()
    events = collections.defaultdict(list)
    for e in prof.events():
        if e.name.startswith(trace.PREFIX) and \
                e.name != trace.PREFIX + "count":
            events[int(e.concrete_inputs[0])].append(e)
    spans = [s for r in trace.records() for s in r["spans"]]
    assert {s["name"] for s in spans} >= {
        "tracer_torch.prep", "tracer_torch.nearest", "tracer_torch.phase_a",
        "tracer_torch.walk", "tracer_torch.bounce"}
    assert sorted(events) == sorted(s["id"] for s in spans)
    for s in spans:
        (e,) = events[s["id"]]
        assert e.name == s["name"]
        if isinstance(s["arg"], int):
            assert e.concrete_inputs[1] == s["arg"]
        assert abs(e.time_range.start * 1e3 + start - s["start_ns"]) \
            < CLOCK_NS, s["name"]
        assert abs(e.time_range.end * 1e3 + start - s["end_ns"]) \
            < CLOCK_NS, s["name"]


def _sync_warning():
    """What torch raises at a host sync in the debug mode "warn"."""
    warnings.warn(trace.SYNC_WARNING + " (Triggered internally at "
                  "c10/cuda/CUDAFunctions.cpp:150.)", UserWarning)


def test_syncs_count_on_the_innermost_span_and_show_nothing(capsys):
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("always")
        with trace.enabled():
            with trace.span("render"):
                with trace.span("bounce", 0):
                    _sync_warning()
                    with trace.span("sync", "overflow"):
                        _sync_warning()
                    _sync_warning()
                with trace.span("bounce", 1):
                    pass
                warnings.warn("another warning")
            with trace.span("prep"):
                pass
        _sync_warning()
    (frame, prep) = trace.records()
    counters = {(s["name"], s["arg"]): s["counters"]
                for s in frame["spans"]}
    assert counters == {("tracer_torch.render", None): {"syncs": 0},
                        ("tracer_torch.bounce", 0): {"syncs": 2},
                        ("tracer_torch.sync", "overflow"): {"syncs": 1},
                        ("tracer_torch.bounce", 1): {}}
    assert prep["counters"] == {"syncs": 0}
    sites = trace.sync_sites()
    assert sum(sites.values()) == 3
    assert {name for name, _, _ in sites} == {"tracer_torch.bounce",
                                             "tracer_torch.sync"}
    assert all(f == __file__ for _, f, _ in sites)
    # The syncs inside the root went to the counter; the other warning,
    # and a sync outside every root, were shown as before.
    assert [str(w.message) for w in shown] == [
        "another warning", trace.SYNC_WARNING + " (Triggered internally at "
        "c10/cuda/CUDAFunctions.cpp:150.)"]
    assert capsys.readouterr().err == ""


def _card_mode(monkeypatch):
    """A stand-in for the card's sync debug mode: CUDA initialised, the
    mode held in a list that records each setting."""
    mode = [0]
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch._C, "_cuda_get_sync_debug_mode",
                        lambda: mode[-1], raising=False)
    monkeypatch.setattr(torch._C, "_cuda_set_sync_debug_mode", mode.append,
                        raising=False)
    monkeypatch.setattr(trace, "_allocs", lambda: None)
    return mode


@pytest.mark.parametrize("raises", [False, True])
def test_the_mode_and_filters_are_restored_after_a_root(monkeypatch,
                                                        raises):
    mode = _card_mode(monkeypatch)
    filters, show = list(warnings.filters), warnings.showwarning
    inside = []
    with contextlib.suppress(KeyError):
        with trace.enabled():
            with trace.span("nearest"):
                inside.append((mode[-1], warnings.showwarning is show))
                _sync_warning()
                if raises:
                    raise KeyError("a root that raises")
    assert inside == [(1, False)]
    assert mode == [0, 1, 0]
    assert warnings.filters == filters and warnings.showwarning is show
    assert trace._store.watch is None and not trace._store.stack
    (root,) = trace.records()
    assert root["counters"] == {"syncs": 1}


def _once_here():
    warnings.warn("shown once at this line", UserWarning)


def test_a_root_shows_no_once_per_location_warning_again():
    """A root swaps the filter list in and out without marking the
    filters changed, so a warning shown once at a line before it stays
    shown once after it."""
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("default")
        _once_here()
        with trace.enabled():
            with trace.span("nearest"):
                _sync_warning()
                _once_here()
        _once_here()
    assert [str(w.message) for w in shown] == ["shown once at this line"]
    (root,) = trace.records()
    assert root["counters"] == {"syncs": 1}


class _Event:
    """A stand-in timing event: each record a step of a fake clock of
    0.25 ms; done once ``DONE`` is set."""
    clock = 0
    made = 0
    DONE = True

    def __init__(self, enable_timing=False):
        assert enable_timing
        _Event.made += 1

    def record(self, stream):
        assert stream == "stream"
        _Event.clock += 1
        self.t = _Event.clock

    def query(self):
        return _Event.DONE

    def elapsed_time(self, end):
        assert self.DONE, "an event read before the device passed it"
        return (end.t - self.t) * 0.25


@pytest.fixture
def card_launch(monkeypatch):
    """``_lib.launch`` with the library, the device index and stream, the
    device guard and the timing events stood in for."""
    lib = type("Lib", (), {"tracer_leafcull": staticmethod(lambda *a: 0)})
    monkeypatch.setattr(_lib, "load", lambda: lib)
    monkeypatch.setattr(_lib, "index", lambda device: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda i: 0, raising=False)
    monkeypatch.setattr(_lib, "launches", collections.Counter())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: "stream")
    monkeypatch.setattr(trace._store, "free", [])
    monkeypatch.setattr(trace._store, "streams", {})
    monkeypatch.setattr(_Event, "DONE", True)
    dev = torch.device("cuda")
    return lambda: _lib.launch("leafcull_cuda", "tracer_leafcull", dev, 1)


def test_launches_count_kernels_and_kernel_ns_by_span(card_launch):
    made = _Event.made
    card_launch()
    assert _Event.made == made and _lib.launches["leafcull_cuda"] == 1
    with trace.enabled():
        with trace.span("nearest"):
            card_launch()
            with trace.span("walk"):
                card_launch()
                card_launch()
    assert _Event.made == made + trace.EVENT_BATCH
    assert _lib.launches["leafcull_cuda"] == 4
    (root,) = trace.records()
    walk = root["spans"][1]
    assert root["counters"] == {"syncs": 0, "kernels": 1,
                                "kernel_ns": 250_000}
    assert walk["counters"] == {"kernels": 2, "kernel_ns": 500_000}
    # Events are made in a batch, and reused once read.
    assert len(trace._store.free) == trace.EVENT_BATCH
    with trace.enabled():
        with trace.span("nearest"):
            card_launch()
    assert _Event.made == made + trace.EVENT_BATCH
    assert len(trace._store.free) == trace.EVENT_BATCH - 2


def test_kernel_events_are_read_once_passed_and_released(card_launch):
    with trace.enabled():
        with trace.span("nearest"):
            card_launch()
        first = trace._store.roots[-1]
        with trace.span("nearest"):
            _Event.DONE = False
            card_launch()
        # The device had passed the first root's events: read at the
        # second root's entry, and released.
        assert not first._events and list(trace._store.pending) == \
            [trace._store.roots[-1]]
        second = trace._store.roots[-1]
        with trace.span("nearest"):
            pass
        # Not passed yet: kept, not read, until the caller's synchronise.
        assert second._events and list(trace._store.pending) == [second]
        _Event.DONE = True
    recs = trace.records()
    assert [r["counters"].get("kernel_ns") for r in recs] == \
        [250_000, 250_000, None]
    assert not second._events
    with trace.enabled():
        with trace.span("prep"):
            pass
    assert not trace._store.pending
