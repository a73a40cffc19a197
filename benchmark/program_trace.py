"""The port's own spans (``doubly_stochastic_dgp_tpu_torch.tracing``) on
the traced stretch's time axis, for the per-layer metrics that read them.

The port records its spans while the profiler runs, stamped with
``time.time_ns()``; a :class:`~benchmark.tracing.Trace` keeps times in
seconds from the stretch's start, and only the harness's ``bench.*``
spans.  :func:`place` matches each root span of the program
(``fit.chunk`` in a training cell, ``serve.request`` in a serving cell)
to the harness span around it (``bench.chunk``, ``bench.serve``), in
order, and shifts every program span by the median of their start
differences.  It reads None, not a wrong number, where the program
records no spans (a program without them), where the counts differ, or
where a matched root falls outside its harness span by more than
``SLACK_S`` after the shift.

Intervals are (start s, end s) pairs; :func:`union`, :func:`subtract` and
:func:`overlap` work on lists of them.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass

ROOTS = {"train": ("fit.chunk", "bench.chunk"),
         "serve": ("serve.request", "bench.serve")}
SLACK_S = 50e-6


@dataclass
class Placed:
    """The program's spans on the stretch's axis, as (name, start s, end
    s); the shift added to their ns stamps; the farthest a root lies
    outside its harness span after it (0 where every root lies inside);
    and the number of matched roots."""

    spans: list
    offset_ns: int
    residual_s: float
    roots: int

    def intervals(self, keep):
        """The intervals of the spans whose name ``keep(name)`` accepts."""
        return [(a, b) for name, a, b in self.spans if keep(name)]


def program_spans():
    """The port's recorded spans, or None where the port has no tracing
    module."""
    try:
        from doubly_stochastic_dgp_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.spans()


def place(trace, kind, spans=None):
    """:class:`Placed` of ``spans`` (default: the port's ring) on
    ``trace``'s axis, matched by the roots of the traffic ``kind``, or
    None."""
    if trace is None or kind not in ROOTS:
        return None
    spans = program_spans() if spans is None else spans
    if not spans:
        return None
    root, around = ROOTS[kind]
    roots = sorted((s for s in spans if s.name == root),
                   key=lambda s: s.start_ns)
    hosts = sorted((h for h in trace.host_spans if h[0] == around),
                   key=lambda h: h[1])
    if not roots or len(roots) != len(hosts):
        return None
    offset = statistics.median_low(round(h[1] * 1e9) - r.start_ns
                                   for r, h in zip(roots, hosts))
    residual = max(max(h[1] - (r.start_ns + offset) * 1e-9,
                       (r.end_ns + offset) * 1e-9 - h[2], 0.0)
                   for r, h in zip(roots, hosts))
    if residual > SLACK_S:
        return None
    placed = [(s.name, (s.start_ns + offset) * 1e-9,
               (s.end_ns + offset) * 1e-9) for s in spans]
    return Placed(placed, offset, residual, len(roots))


def union(intervals):
    """The union of ``intervals`` as sorted disjoint intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        elif b > a:
            out.append((a, b))
    return out


def subtract(intervals, cut):
    """``union(intervals)`` less ``union(cut)``."""
    out, cut = [], union(cut)
    for a, b in union(intervals):
        for c, d in cut:
            if d <= a or c >= b:
                continue
            if c > a:
                out.append((a, c))
            a = max(a, d)
            if a >= b:
                break
        if a < b:
            out.append((a, b))
    return out


def overlap(x, y):
    """Seconds that ``union(x)`` and ``union(y)`` share."""
    x, y = union(x), union(y)
    total, i, j = 0.0, 0, 0
    while i < len(x) and j < len(y):
        (a, b), (c, d) = x[i], y[j]
        total += max(0.0, min(b, d) - max(a, c))
        if b < d:
            i += 1
        else:
            j += 1
    return total


def length(intervals):
    """Seconds ``union(intervals)`` covers."""
    return sum(b - a for a, b in union(intervals))
