"""Spans and counters of the port's host stages: where a call into the
port spends its host time, and how often the rare events of set-up
(a plan captured, a kernel library built or loaded) happen.

* :func:`span` — ``with span("repro_torch.scan.launch"): ...`` marks one
  stage. While recording is off (the default) it costs one test of a
  module flag and returns one shared no-op: nothing is allocated and no
  clock is read. While it is on (:func:`recording`) the span keeps
  ``(name, start_ns, end_ns, parent, call)`` on ``time.perf_counter_ns``
  in a bounded store (:data:`MAX_SPANS`; past it spans are dropped and
  counted). ``parent`` is the index in the store of the span it opened
  inside, -1 for an outermost one; every span opened inside one
  outermost span shares its ``call`` id. While a ``torch.profiler``
  profile is active, a recorded span also opens a
  ``torch.profiler.record_function`` range of the same name, so it sits
  on the profiler's timeline beside the device operations.
* :func:`count` — counters of rare events; they always count.
* :func:`snapshot` — the spans, the counters, and the kernels' own
  launch counters (``kernels/rows_dot.py``, ``kernels/block_scan.py``,
  ``kernels/topk.py``) read where they live.
* :func:`summary` — for each span name its count, total µs and self µs
  (the span less what its child spans cover).

Spans sit at layer boundaries only (``serve/api.py``,
``serve/pipeline.py``, ``kernels/ops.py``, ``kernels/block_scan.py``,
``kernels/build.py``, ``core/layout.py``, ``core/forward_index.py``),
never inside code a CUDA graph captures: a host range there would run
once, at capture, and never at replay.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import NamedTuple

__all__ = ["MAX_SPANS", "Span", "span", "recording", "count", "counters", "reset", "snapshot",
           "summary"]

#: spans kept while recording; later ones are dropped and counted
MAX_SPANS = 1 << 16

#: rare events, by name; they always count (``plan.captures``,
#: ``kernels.loads``, ``kernels.compiles``; ``topk.selects`` and
#: ``topk.sorts``, the flat engine's two top-k paths, once a call or capture)
counters: dict[str, int] = {}

_recording = False
_lock = threading.Lock()
#: [name, start_ns, end_ns, parent's slot, call, own slot]; end_ns None
#: while open, own slot -1 once dropped
_store: list = []
_dropped = 0
_calls = 0
_local = threading.local()  # .open: the thread's stack of open spans


class Span(NamedTuple):
    """One recorded span; ``parent`` is an index into the same snapshot's
    spans, -1 for an outermost span."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    call: int


class _NoOp:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoOp()


class _Recorded:
    __slots__ = ("name", "slot", "range")

    def __init__(self, name: str):
        self.name = name
        self.slot = None
        self.range = None

    def __enter__(self):
        global _calls, _dropped
        stack = getattr(_local, "open", None)
        if stack is None:
            stack = _local.open = []
        parent = stack[-1] if stack else None
        with _lock:
            if parent is None:
                _calls += 1
                call = _calls
            else:
                call = parent[4]
            if len(_store) < MAX_SPANS:
                self.slot = [self.name, 0, None, -1 if parent is None else parent[5], call,
                             len(_store)]
                _store.append(self.slot)
            else:
                _dropped += 1
                self.slot = [self.name, 0, None, -1, call, -1]
        stack.append(self.slot)
        import torch

        if torch._C._autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.slot[1] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.slot[2] = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _local.open.pop()
        return False


def span(name: str):
    """A context manager marking the host stage ``name``
    (``repro_torch.<stage>``); the shared no-op while not recording."""
    if not _recording:
        return _NOOP
    return _Recorded(name)


@contextlib.contextmanager
def recording():
    """Record spans for the duration; the previous state is restored
    after."""
    global _recording
    was, _recording = _recording, True
    try:
        yield
    finally:
        _recording = was


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _lock:
        counters[name] = counters.get(name, 0) + n


def reset() -> None:
    """Forget every recorded span and the drop count (counters stay).
    Call it outside any open span."""
    global _dropped
    with _lock:
        _store.clear()
        _dropped = 0


def snapshot() -> dict:
    """``spans`` (closed ones, as :class:`Span`, parents re-indexed into
    this list), ``dropped``, ``counters``, and ``launches``: the launch
    counters of ``kernels/rows_dot.py``, ``kernels/block_scan.py`` and
    ``kernels/topk.py`` as they read now."""
    from .kernels import block_scan, rows_dot, topk

    with _lock:
        rows = [list(s) for s in _store]
        dropped, counts = _dropped, dict(counters)
    closed = [s for s in rows if s[2] is not None]
    where = {s[5]: i for i, s in enumerate(closed)}
    spans = [Span(s[0], s[1], s[2], where.get(s[3], -1), s[4]) for s in closed]
    launches = {
        "rows_dot": {"launches": rows_dot.launches,
                     "variants": dict(rows_dot.variant_launches),
                     "stages": dict(rows_dot.stage_launches),
                     "captured_variants": dict(rows_dot.captured_variant_launches),
                     "captured_stages": dict(rows_dot.captured_stage_launches)},
        "block_scan": {"launches": block_scan.launches,
                       "variants": dict(block_scan.variant_launches),
                       "fused": dict(block_scan.fused_launches),
                       "stages": dict(block_scan.stage_launches)},
        "topk": {"launches": topk.launches, "captured_launches": topk.captured_launches},
    }
    return {"spans": spans, "dropped": dropped, "counters": counts, "launches": launches}


def summary(spans=None) -> dict:
    """{name: {"count", "total_us", "self_us"}} over ``spans`` (default:
    the recorded ones); a span's self time is its duration less its
    children's."""
    if spans is None:
        spans = snapshot()["spans"]
    child_ns = [0] * len(spans)
    for s in spans:
        if s.parent >= 0:
            child_ns[s.parent] += s.end_ns - s.start_ns
    out: dict = {}
    for s, inner in zip(spans, child_ns):
        d = out.setdefault(s.name, {"count": 0, "total_us": 0.0, "self_us": 0.0})
        d["count"] += 1
        d["total_us"] += (s.end_ns - s.start_ns) / 1e3
        d["self_us"] += (s.end_ns - s.start_ns - inner) / 1e3
    return out
