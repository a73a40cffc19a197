"""The cases of the port's spans and counters (no test items here).

``tests/test_torch_modules.py`` runs :func:`check_tracing` inside its
test function: the spans and counters of ``tracing.py`` on the CPU (off
by default, the trainer's and the server's span trees under ``record()``
and under ``torch.profiler``, on the profiler's clock and with no
profiler event of the port's own; the counters' snapshot; the ring's
bound) and ``monitor.profile_trace``'s merged Chrome trace, each case in
turn, the failing case named in the message; where a card is present,
also the graph counters on a capture and a replay.  On a card without
JAX: ``python -c "import sys; sys.path.insert(0, 'tests');
import test_torch_tracing as t; t.check_tracing()"``.  Imports no
JAX."""

import json
import tempfile
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

import doubly_stochastic_dgp_tpu_torch as port
from doubly_stochastic_dgp_tpu_torch import tracing
from doubly_stochastic_dgp_tpu_torch.training.monitor import profile_trace


def _model(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(40, 2))
    Y = np.sin(X[:, :1])
    return port.DGP.build(X, Y, X[:6], [port.RBF(2), port.RBF(2)],
                          port.Gaussian(0.05), num_samples=2, device="cpu")


def _fit(model, **kw):
    kw = dict(dict(batch_size=16, log_every=10, scan_steps=5), **kw)
    return port.fit(model, 15, 0.01, **kw)


def _children(spans, parent):
    return [s.name for s in spans if s.parent == parent.index]


def _off_records_nothing(tmp_path):
    model = _model()
    assert tracing.span("fit.chunk") is tracing.span("serve.request")
    _fit(model)
    serve = port.make_server(model, S=3, batch_buckets=(1, 8))
    serve(np.zeros((5, 2)))
    assert tracing.spans() == []


def _fit_tree(tmp_path):
    model = _model()
    calls = []
    with tracing.record():
        _, history = _fit(model, ckpt_dir=str(tmp_path), ckpt_every=5,
                          callbacks=[lambda *a: calls.append(a[0])])
    assert [h["iter"] for h in history] == [10, 15] and calls == [10, 15]
    spans = tracing.spans()
    by_index = {s.index: s for s in spans}
    roots = [s for s in spans if s.parent == -1]
    assert [(s.name, s.trace) for s in roots] == [
        ("fit.chunk", 0), ("fit.checkpoint", 0),
        ("fit.chunk", 1), ("fit.checkpoint", 1), ("fit.log", 1),
        ("fit.chunk", 2), ("fit.checkpoint", 2), ("fit.log", 2)]
    for root in roots:
        want = {"fit.chunk": ["fit.eager"], "fit.checkpoint": [],
                "fit.log": ["fit.sync", "fit.callbacks"]}[root.name]
        assert _children(spans, root) == want, root
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent != -1:
            p = by_index[s.parent]
            assert s.trace == p.trace
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    assert all(a.end_ns <= b.start_ns for a, b in zip(roots, roots[1:]))


def _bucketed_serve_tree(tmp_path):
    serve = port.make_server(_model(), S=3, batch_buckets=(1, 8))
    before = tracing.counters()
    with tracing.record():
        mean, var = serve(np.zeros((5, 2)))
    after = tracing.counters()
    assert mean.shape == (3, 5, 1) and var.shape == (3, 5, 1)
    spans = tracing.spans()
    roots = [s for s in spans if s.parent == -1]
    # the warm-up served buckets 1 and 8 (requests 0 and 1)
    assert [(s.name, s.trace) for s in roots] == [("serve.request", 2)]
    assert _children(spans, roots[0]) == [
        "serve.input", "serve.pad", "serve.seed", "serve.eager",
        "serve.concat"]
    assert all(s.trace == 2 for s in spans)
    delta = {k: after[k] - before[k] for k in
             ("serve.requests", "serve.rows", "serve.padded_rows")}
    assert delta == {"serve.requests": 1, "serve.rows": 5,
                     "serve.padded_rows": 3}


def _profiler_clock_no_profiler_events(tmp_path):
    model = _model()
    serve = port.make_server(model, S=3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer"):
            _fit(model)
            serve(np.zeros((4, 2)))
    spans = tracing.spans()
    names = {s.name for s in spans}
    assert {"fit.chunk", "fit.eager", "fit.log", "fit.sync",
            "fit.callbacks", "serve.request", "serve.eager"} <= names
    base = prof.profiler.kineto_results.trace_start_ns()
    events = prof.events()
    outer = next(e for e in events if e.name == "outer"
                 and e.device_type == DeviceType.CPU)
    lo = base + outer.time_range.start * 1e3
    hi = base + outer.time_range.end * 1e3
    for s in spans:
        assert lo <= s.start_ns <= s.end_ns <= hi, s
    assert not names & {e.name for e in events}
    assert not any(e.name.startswith(("fit.", "serve.")) for e in events)


def _counters_read_the_launch_counters(tmp_path):
    from doubly_stochastic_dgp_tpu_torch.ops.cuda.gram import rbf_gram
    c = tracing.counters()
    for k in ("graph.captures", "graph.capture_s", "graph.replays",
              "serve.requests", "serve.rows", "serve.padded_rows"):
        assert k in c
    pairs = {"fused_conditional.launches": (port.fused_conditional,
                                            "launches"),
             "fused_conditional.backward_launches": (
                 port.fused_conditional, "backward_launches"),
             "fused_conditional_saved.launches": (
                 port.fused_conditional_saved, "launches"),
             "fused_conditional_saved.backward_launches": (
                 port.fused_conditional_saved, "backward_launches"),
             "rbf_gram.launches": (rbf_gram, "launches"),
             "psi2_core.launches": (port.psi2_core, "launches"),
             "psi2_core.backward_launches": (port.psi2_core,
                                             "backward_launches")}
    for k, (f, attr) in pairs.items():
        old = getattr(f, attr)
        try:
            setattr(f, attr, old + 7)
            assert tracing.counters()[k] == old + 7, k
        finally:
            setattr(f, attr, old)


def _ring_bounded_and_clears(tmp_path):
    with tracing.record():
        with tracing.span("outer", trace=5):
            for _ in range(tracing.RING + 10):
                with tracing.span("inner"):
                    pass
    # the outer span started first and ended last: the 11 oldest inner
    # spans left the ring
    outer, *inner = tracing.spans()
    assert len(inner) == tracing.RING - 1
    assert outer.name == "outer" and outer.trace == 5
    assert all(s.parent == outer.index and s.trace == 5 for s in inner)
    assert inner[0].index == outer.index + 12
    tracing.clear()
    assert tracing.spans() == []


def _profile_trace_merges_the_spans(tmp_path):
    model = _model()
    with profile_trace(str(tmp_path)) as pt:
        _fit(model)
    assert {s.name for s in pt.spans} >= {"fit.chunk", "fit.log"}
    trace = json.loads((tmp_path / "trace.json").read_text())
    events = trace["traceEvents"]
    ours = [e for e in events if e.get("cat") == "program_span"]
    assert sorted(e["name"] for e in ours) == sorted(
        s.name for s in pt.spans)
    theirs = [e for e in events if e.get("ph") == "X"
              and e.get("cat") != "program_span"]
    lo = min(e["ts"] for e in theirs)
    hi = max(e["ts"] + e.get("dur", 0) for e in theirs)
    for e in ours:
        assert lo <= e["ts"] and e["ts"] + e["dur"] <= hi, e


def _graph_counters_tick_on_capture_and_replay(tmp_path):
    from doubly_stochastic_dgp_tpu_torch.graphs import CapturedCall
    x = torch.ones(1024, device="cuda")
    before = tracing.counters()
    call = CapturedCall(lambda: x * 2.0, lambda: x * 2.0, "doubling")
    captured = tracing.counters()
    out = call.replay()
    torch.cuda.synchronize()
    replayed = tracing.counters()
    assert torch.equal(out, torch.full_like(x, 2.0))
    assert captured["graph.captures"] == before["graph.captures"] + 1
    assert captured["graph.capture_s"] > before["graph.capture_s"]
    assert captured["graph.replays"] == before["graph.replays"]
    assert replayed["graph.replays"] == captured["graph.replays"] + 1


CASES = [_off_records_nothing, _fit_tree, _bucketed_serve_tree,
         _profiler_clock_no_profiler_events,
         _counters_read_the_launch_counters, _ring_bounded_and_clears,
         _profile_trace_merges_the_spans]


def check_tracing():
    """Runs every case in turn (the graph counters' only on a card), each
    in a directory of its own."""
    cases = CASES + ([_graph_counters_tick_on_capture_and_replay]
                     if torch.cuda.is_available() else [])
    with tempfile.TemporaryDirectory() as tmp:
        for case in cases:
            path = Path(tmp) / case.__name__
            path.mkdir()
            tracing.clear()
            try:
                case(path)
            except AssertionError as e:
                raise AssertionError(f"tracing case {case.__name__}: "
                                     f"{e}") from e
            finally:
                tracing.clear()
