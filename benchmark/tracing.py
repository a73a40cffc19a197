"""The traced run's profile: ``torch.profiler`` over a steady stretch of the
window, and what the per-layer metrics read from it.

The stretch starts and ends at a point where the host has synchronized
with the device (a loss read, a request's host copy), at the first such
point after the middle of the window less ``trace_seconds``, and runs
whole units until ``trace_seconds`` have passed.  Before it opens, a
shield of small launches takes the records the profiler loses when it
starts.  The drivers wrap their calls in ``record_function`` spans named
``bench.*`` (the harness's own files only), which label the device's idle
gaps by what the host was doing.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

SPAN = "bench.profiled"
SHIELD_LAUNCHES = 64


@dataclass
class Trace:
    """What a profiled stretch holds: device operations as (name, start
    s, end s) relative to the stretch's start, the harness's host spans
    likewise, the stretch's seconds, and the units (steps or requests)
    and rows it completed."""

    ops: list
    host_spans: list
    span_s: float
    units: int
    rows: int
    busy_s: float = 0.0
    gaps: list = field(default_factory=list)


def union_gaps(ops, span_s):
    """(busy seconds, idle gaps as (start, end)) of the union of the ops'
    intervals within [0, span_s]."""
    busy, gaps, cursor = 0.0, [], 0.0
    for _, start, end in sorted(ops, key=lambda o: o[1]):
        start, end = max(start, 0.0), min(end, span_s)
        if end <= cursor:
            continue
        if start > cursor:
            gaps.append((cursor, start))
            cursor = start
        busy += end - cursor
        cursor = end
    if cursor < span_s:
        gaps.append((cursor, span_s))
    return busy, gaps


def label_of(t, host_spans):
    """The innermost harness span holding the host time ``t``."""
    best = None
    for name, start, end in host_spans:
        if start <= t <= end and (best is None or end - start < best[1]):
            best = (name, end - start)
    return best[0] if best else "bench.host"


def breakdown(trace, top=10):
    """{"device_ops": the ops with most device time, by name, "idle_gaps":
    the longest idle gaps, each by the harness span the host was in}."""
    by_name = {}
    for name, start, end in trace.ops:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(trace.gaps, key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n[:200], s] for n, s in ops],
            "idle_gaps": [[label_of(a, trace.host_spans), b - a]
                          for a, b in gaps]}


class Tracer:
    """Profiles one stretch of the window; ``boundary`` is called by the
    mix at each point where the host has synchronized."""

    def __init__(self, window_s, trace_s):
        self.start_at = max(0.0, window_s / 2 - trace_s)
        self.trace_s = trace_s
        self.state = "idle"
        self.prof = self.span = None
        self.t0 = 0.0
        self.units0 = self.rows0 = 0
        self.units = self.rows = 0

    def boundary(self, elapsed, units, rows):
        from torch.profiler import ProfilerActivity, profile, record_function
        if self.state == "idle" and elapsed >= self.start_at:
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            shield = torch.zeros(1, device="cuda")
            for _ in range(SHIELD_LAUNCHES):
                shield.add_(1.0)
            torch.cuda.synchronize()
            self.span = record_function(SPAN)
            self.span.__enter__()
            self.t0, self.units0, self.rows0 = time.perf_counter(), units, rows
            self.state = "open"
        elif self.state == "open" and (time.perf_counter() - self.t0
                                       >= self.trace_s):
            self.span.__exit__(None, None, None)
            torch.cuda.synchronize()
            self.prof.stop()
            self.units, self.rows = units - self.units0, rows - self.rows0
            self.state = "done"

    def result(self):
        """The :class:`Trace` of the stretch, or None if it never closed."""
        if self.state != "done":
            return None
        events = self.prof.events()
        span = next(e for e in events if e.name == SPAN)
        t0, t1 = span.time_range.start, span.time_range.end
        ops, host = [], []
        for e in events:
            start, end = e.time_range.start, e.time_range.end
            if end <= t0 or start >= t1:
                continue
            rel = ((start - t0) * 1e-6, (end - t0) * 1e-6)
            ours = e.name.startswith("bench.")
            if e.device_type == torch.autograd.DeviceType.CUDA:
                # the harness's spans also appear on the device's timeline
                # as annotations, which are no device work
                if not ours:
                    ops.append((e.name, *rel))
            elif ours and e.name != SPAN:
                host.append((e.name, *rel))
        trace = Trace(ops, host, (t1 - t0) * 1e-6, self.units, self.rows)
        trace.busy_s, trace.gaps = union_gaps(ops, trace.span_s)
        return trace


def is_kernel(name):
    """A device op that is a kernel, not a copy or a memset."""
    return not name.startswith(("Memcpy", "Memset", "memcpy", "memset"))
