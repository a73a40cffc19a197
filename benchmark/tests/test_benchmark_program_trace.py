"""``program_trace.py`` and the readers of the port's spans and counters on
a synthetic traced stretch: the spans placed by their roots, the idle and
host time attributed, and None where the counts differ, a root lies
outside its harness span, or the program has no spans."""

import sys
from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark import program_trace as pt
from benchmark.tracing import Trace
from doubly_stochastic_dgp_tpu_torch import tracing

BASE = 1_792_000_000_000_000_000      # a time.time_ns() of the program
LAG = 5_000                           # its roots start 5 us after the bench's


def _spans(placed):
    """Program spans at ``placed`` (name, start s, end s, parent) on the
    stretch's axis, stamped as the program stamps them."""
    out = []
    for i, (name, a, b, parent) in enumerate(placed):
        out.append(tracing.Span(i, name, BASE + round(a * 1e9) + LAG,
                                BASE + round(b * 1e9) + LAG, parent, i))
    return out


TRAIN = [("fit.chunk", 0.010, 0.0199, -1),
         ("fit.draws", 0.010, 0.011, 0), ("fit.replay", 0.011, 0.019, 0),
         ("fit.output", 0.019, 0.0199, 0),
         ("fit.chunk", 0.040, 0.0499, -1),
         ("fit.draws", 0.040, 0.041, 4), ("fit.replay", 0.041, 0.049, 4),
         ("fit.output", 0.049, 0.0499, 4),
         ("fit.log", 0.060, 0.090, -1), ("fit.sync", 0.060, 0.070, 8),
         ("fit.callbacks", 0.075, 0.085, 8)]
TRAIN_TRACE = dict(
    host_spans=[("bench.chunk", 0.010, 0.020), ("bench.chunk", 0.040, 0.050)],
    gaps=[(0.0, 0.0105), (0.0185, 0.0195), (0.030, 0.041), (0.065, 0.080),
          (0.095, 0.1)])
SERVE = [("serve.request", 0.010, 0.012, -1),
         ("serve.replay", 0.0105, 0.0115, 0),
         ("serve.request", 0.040, 0.043, -1)]
SERVE_TRACE = dict(
    host_spans=[("bench.serve", 0.010, 0.0125),
                ("bench.host_copy", 0.0125, 0.02),
                ("bench.serve", 0.040, 0.0435)],
    gaps=[(0.0, 0.011), (0.0115, 0.03)])


def _trace(host_spans, gaps, units):
    return Trace([], host_spans, 0.1, units, units * 1000, 0.08, gaps)


def _ctx(kind, trace):
    return SimpleNamespace(cell="x", config={}, traffic={"kind": kind},
                           window={}, trace=trace)


def test_place_shifts_every_span_by_the_roots():
    placed = pt.place(_trace(**TRAIN_TRACE, units=20), "train",
                      _spans(TRAIN))
    assert placed.roots == 2 and placed.offset_ns == -(BASE + LAG)
    assert placed.residual_s == pytest.approx(0.0, abs=1e-12)
    for (name, a, b), (want, wa, wb, _) in zip(placed.spans, TRAIN):
        assert name == want
        assert a == pytest.approx(wa, abs=1e-12)
        assert b == pytest.approx(wb, abs=1e-12)


def test_place_reads_none_on_a_count_mismatch_or_a_root_outside():
    trace = _trace(**TRAIN_TRACE, units=20)
    extra = TRAIN + [("fit.chunk", 0.070, 0.071, -1)]
    assert pt.place(trace, "train", _spans(extra)) is None
    assert pt.place(trace, "train", []) is None
    assert pt.place(None, "train", _spans(TRAIN)) is None
    late = [list(s) for s in TRAIN]
    late[4][2] = 0.050 + 40e-6               # 40 us past its bench span
    placed = pt.place(trace, "train", _spans(map(tuple, late)))
    assert placed.residual_s == pytest.approx(40e-6, abs=1e-9)
    late[4][2] = 0.050 + 60e-6
    assert pt.place(trace, "train", _spans(map(tuple, late))) is None


def test_interval_arithmetic():
    assert pt.union([(3, 4), (0, 1), (0.5, 2), (5, 5)]) == [(0, 2), (3, 4)]
    assert pt.subtract([(0, 10)], [(1, 2), (4, 5), (9, 12)]) == [
        (0, 1), (2, 4), (5, 9)]
    assert pt.overlap([(0, 2), (3, 6)], [(1, 4), (5, 7)]) == 3
    assert pt.length([(0, 2), (1, 3)]) == 3


def _read(name, kind, trace, spans, monkeypatch):
    monkeypatch.setattr(pt, "program_spans", lambda: spans)
    return harness.reader(name)(_ctx(kind, trace))


@pytest.mark.parametrize("name,kind,trace,spans,want", [
    # gaps inside fit.* less fit.callbacks: 0.5 + 1 + 1 + 10 ms over 20
    ("trainer_idle_ms_per_step.train", "train", TRAIN_TRACE, TRAIN, 0.625),
    # fit.* less replay, sync and callbacks: 1.9 + 1.9 + 10 ms over 20
    ("trainer_host_ms_per_step.train", "train", TRAIN_TRACE, TRAIN, 0.69),
    # gaps inside serve.request: 1 + 0.5 ms over 2
    ("server_idle_ms_per_request.serve", "serve", SERVE_TRACE, SERVE, 0.75),
    # serve.request less serve.replay: 1 + 3 ms over 2
    ("server_host_ms_per_request.serve", "serve", SERVE_TRACE, SERVE, 2.0),
])
def test_span_readers(name, kind, trace, spans, want, monkeypatch):
    units = 20 if kind == "train" else 2
    t = _trace(**trace, units=units)
    assert _read(name, kind, t, _spans(spans), monkeypatch) == \
        pytest.approx(want, rel=1e-9)
    other = "serve" if kind == "train" else "train"
    assert _read(name, other, t, _spans(spans), monkeypatch) is None
    # a program without spans (the parent of this metric) reads nothing
    assert _read(name, kind, t, None, monkeypatch) is None
    assert _read(name, kind, None, _spans(spans), monkeypatch) is None


def test_graph_capture_reader(monkeypatch):
    read = harness.reader("graph_capture_s")
    ctx = _ctx("train", None)
    monkeypatch.setattr(tracing, "counters", lambda: {
        "graph.captures": 2, "graph.capture_s": 7.25})
    assert read(ctx) == 7.25
    monkeypatch.setattr(tracing, "counters", lambda: {
        "graph.captures": 0, "graph.capture_s": 0.0})
    assert read(ctx) is None
    # a port without the tracing module
    import doubly_stochastic_dgp_tpu_torch as port
    monkeypatch.delattr(port, "tracing")
    monkeypatch.setitem(sys.modules, "doubly_stochastic_dgp_tpu_torch.tracing",
                        None)
    assert read(ctx) is None
    assert pt.program_spans() is None
