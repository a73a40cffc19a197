"""Spans and counters of the port's own work: the trainer's chunks and log
events (``training/loop.py``), the server's requests (``serving.py``) and
the captures and replays of its CUDA graphs (``graphs.py``).

Spans.  ``with span(name, trace=None):`` around a piece of host work
records a :class:`Span`: its name, its start and end on the host clock in
ns, the index of the span that encloses it (-1 for a root) and a trace
id, which the root takes from ``trace`` (the chunk's index in ``fit``,
the request's index in ``make_server``'s ``serve``) and every span inside
it shares.  Records go into one bounded in-memory ring of :data:`RING`
spans per process, oldest dropped first; :func:`spans` returns them in
the order they started and :func:`clear` empties the ring.

Spans record only while a ``torch.profiler`` profile runs, or inside
:func:`record`, for an operator who wants them without the profiler's
cost.  Otherwise ``span`` reads the two flags and returns a shared no-op:
no clock read, no allocation.  A span decides at its start whether it
records.  The clock is ``time.time_ns()``, the clock the profiler stamps
its host events with (``CLOCK_REALTIME`` on Linux), so spans and a
profile's kernels lie on one time axis; the port emits no profiler event
of its own (no ``record_function``), which would also appear on the
device timeline as an annotation.  ``training.monitor.profile_trace``
merges the spans of its profile into the Chrome trace it writes.

Counters, always on, at events that are rare or once a call:
``graph.captures`` and ``graph.capture_s`` (each ``CapturedCall``: its
eager warm-up and its capture, host seconds, which end after the device
finished the warm-up), ``graph.replays``, and ``serve.requests``,
``serve.rows`` (the rows asked for) and ``serve.padded_rows`` (the rows a
bucketed server added to reach its buckets) over every ``serve`` call,
``make_server``'s warm-up requests included.  :func:`counters` reads them
with the kernels' launch counters (``fused_conditional.launches`` and the
rest, which count only launches made outside a graph replay) into one
snapshot.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from contextlib import contextmanager
from typing import NamedTuple

import torch.autograd.profiler as _profiler

__all__ = ["Span", "RING", "span", "record", "spans", "clear", "count",
           "counters"]

RING = 2 ** 16


class Span(NamedTuple):
    index: int          # the span's number, in the order spans started
    name: str
    start_ns: int       # time.time_ns() at the start
    end_ns: int
    parent: int         # the index of the enclosing span, -1 for a root
    trace: int          # the root's trace id, -1 where it has none


_ring = collections.deque(maxlen=RING)
_index = itertools.count()
_local = threading.local()
_lock = threading.Lock()
_recording = 0
_counts = {"graph.captures": 0, "graph.capture_s": 0.0, "graph.replays": 0,
           "serve.requests": 0, "serve.rows": 0, "serve.padded_rows": 0}


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    """A span that records: pushed on this thread's stack while open."""

    __slots__ = ("name", "trace", "index", "parent", "start")

    def __init__(self, name, trace):
        self.name, self.trace = name, trace

    def __enter__(self):
        stack = _stack()
        top = stack[-1] if stack else None
        self.index = next(_index)
        self.parent = -1 if top is None else top.index
        if self.trace is None:
            self.trace = -1 if top is None else top.trace
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _stack().pop()
        _ring.append(Span(self.index, self.name, self.start, end,
                          self.parent, self.trace))
        return False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, trace=None):
    """A context manager that records the span ``name`` while recording is
    on (a ``torch.profiler`` profile, or :func:`record`); ``trace``: the
    trace id of a root span (a span inside another takes its root's)."""
    if not (_recording or _profiler._is_profiler_enabled):
        return _OFF
    return _Open(name, trace)


@contextmanager
def record():
    """Spans record while inside, without a profiler."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def spans():
    """The recorded spans still in the ring, in the order they started."""
    return sorted(_ring)


def clear():
    """Empties the ring."""
    _ring.clear()


def count(name: str, n=1):
    """Adds ``n`` to the counter ``name``."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def counters():
    """A snapshot of every counter: those of this module and the kernels'
    launch counters, under their names (``rbf_gram.launches``, ...)."""
    from .ops.cuda.conditional import (fused_conditional,
                                       fused_conditional_saved)
    from .ops.cuda.gram import rbf_gram
    from .ops.cuda.psi2 import psi2_core
    with _lock:
        snap = dict(_counts)
    for name, f in (("fused_conditional", fused_conditional),
                    ("fused_conditional_saved", fused_conditional_saved),
                    ("rbf_gram", rbf_gram), ("psi2_core", psi2_core)):
        snap[f"{name}.launches"] = f.launches
        if hasattr(f, "backward_launches"):
            snap[f"{name}.backward_launches"] = f.backward_launches
    return snap
