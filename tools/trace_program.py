#!/usr/bin/env python3
"""Where the port's host time and the device's idle time go, by the port's
own spans (``doubly_stochastic_dgp_tpu_torch/tracing.py``), in cells of
the benchmark, on one NVIDIA GPU:

    python3 tools/trace_program.py --workload <cell>[,<cell>...] \
        --seed <n> [--seconds 10] [--turns off,on,on,off] [--out file]
    python3 tools/trace_program.py --workload <train cell>[,...] \
        --seed <n> --toggle 3 [--out file]

For each cell, first a traced run as ``benchmark/run.py --trace 1`` makes
one (``harness.run_cell``): its metrics, the placement of the port's spans
on the profiled stretch (``benchmark/program_trace.py``: the matched
roots, the shift, the residual), and the stretch's idle gaps and host
time by the innermost span that holds them (a span's self time: its
interval less its children's), in ms a unit (a step or a request), with
the gaps outside every program span by the harness span around them.
Then a new driver of the cell drives windows of ``--seconds`` in the
order ``--turns``, recording the port's spans (``tracing.record()``, no
profiler) in the ``on`` turns: each window's end-to-end numbers (train:
steps/s and rows/s; serve: rows/s, p50 and p95 ms), and in the ``on``
turns each span's host ms (count, mean, median, p95, max), the host
metric of the cell's layer (``trainer_host_ms_per_step.train`` or
``server_host_ms_per_request.serve``) by its definition on these spans,
which the profiler does not slow, and, for the trainer, ``fit.replay`` in
the first chunk after each loss read apart from the rest.  Prints one
JSON line a cell (and appends it to ``--out``).

With ``--toggle N``, instead, one ``fit`` of each training cell runs
under the profiler for 2 x 2N stretches of one log interval (on, off,
off, on, ...), the port's spans recording in the ``on`` stretches only:
each stretch's device idle share, kernels a step and longest gap, so that
the spans' own cost under the profiler shows beside the profiler's.

Needs a CUDA device; not used by the package or the benchmark.
"""

import argparse
import contextlib
import json
import statistics
import sys
import time
import types
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark import program_trace as pt  # noqa: E402
from benchmark.tracing import Tracer, is_kernel, label_of  # noqa: E402
import doubly_stochastic_dgp_tpu_torch as port  # noqa: E402
from doubly_stochastic_dgp_tpu_torch import tracing  # noqa: E402


def self_intervals(placed):
    """{span name: its spans' intervals less their direct children's}."""
    spans = tracing.spans()
    by_index = {s.index: i for i, s in enumerate(spans)}
    children = {}
    for i, s in enumerate(spans):
        if s.parent in by_index:
            children.setdefault(by_index[s.parent], []).append(i)
    out = {}
    for i, (name, a, b) in enumerate(placed.spans):
        cut = [placed.spans[j][1:] for j in children.get(i, [])]
        out.setdefault(name, []).extend(pt.subtract([(a, b)], cut))
    return out


def attribution(ctx):
    """The traced stretch's idle gaps and host time by innermost span."""
    t = ctx.trace
    kind = ctx.traffic["kind"]
    placed = pt.place(t, kind)
    if placed is None:
        return {"placed": None}
    units = max(t.units, 1)
    own = self_intervals(placed)
    inside = pt.union(iv for ivs in own.values() for iv in ivs)
    idle = {name: 1e3 * pt.overlap(t.gaps, ivs) / units
            for name, ivs in own.items()}
    host = {name: 1e3 * pt.overlap(ivs, [(0.0, t.span_s)]) / units
            for name, ivs in own.items()}
    outside = {}
    for a, b in pt.subtract(t.gaps, inside):
        label = label_of(a, t.host_spans)
        outside[label] = outside.get(label, 0.0) + 1e3 * (b - a) / units
    gaps = sorted(t.gaps, key=lambda g: g[0] - g[1])[:10]
    longest = []
    for a, b in gaps:
        share, name = max(((pt.overlap([(a, b)], ivs), n)
                           for n, ivs in own.items()), default=(0.0, None))
        longest.append([1e3 * (b - a), name if share > 0
                        else label_of(a, t.host_spans), 1e3 * a])
    return {"roots": placed.roots, "offset_ns": placed.offset_ns,
            "residual_us": 1e6 * placed.residual_s, "units": t.units,
            "stretch_ms": 1e3 * t.span_s,
            "idle_ms_per_unit": 1e3 * pt.length(t.gaps) / units,
            "idle_ms_per_unit_by_span": idle,
            "idle_ms_per_unit_outside": outside,
            "host_self_ms_per_unit_by_span": host,
            "longest_gaps_ms_span_at_ms": longest}


def traced(workload, seed, seconds):
    """(result line, attribution) of one traced run of ``workload``."""
    got = {}
    reader = harness.reader

    def catching(name, here=harness.ROOT):
        read = reader(name, here)

        def caught(ctx):
            got["ctx"] = ctx
            return read(ctx)
        return caught

    tracing.clear()
    harness.reader = catching
    try:
        result, phases = harness.run_cell(workload, seed, seconds, 1,
                                          "cuda:0", time.perf_counter())
    finally:
        harness.reader = reader
    return result, phases, attribution(got["ctx"])


def span_stats(spans):
    """{name: host ms of its spans: count, mean, median, p95, max}."""
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(1e-6 * (s.end_ns - s.start_ns))
    return {n: {"count": len(v), "mean": statistics.fmean(v),
                "median": statistics.median(v),
                "p95": float(np.percentile(v, 95)), "max": max(v)}
            for n, v in sorted(by.items())}


def replay_after_log(spans):
    """Host ms of ``fit.replay`` in the first chunk after each loss read
    (after a ``fit.log``) and in the other chunks."""
    roots = [s for s in spans if s.parent == -1]
    replay = {s.parent: s for s in spans if s.name == "fit.replay"}
    after, rest, previous = [], [], None
    for r in roots:
        if r.name == "fit.chunk" and r.index in replay:
            ms = 1e-6 * (replay[r.index].end_ns - replay[r.index].start_ns)
            (after if previous == "fit.log" else rest).append(ms)
        previous = r.name
    return {"after_log": after,
            "others_median": statistics.median(rest) if rest else None,
            "others_max": max(rest) if rest else None,
            "others_count": len(rest)}


HOST_CUT = {"train": ("fit.chunk", "fit.", ("fit.replay", "fit.sync",
                                             "fit.callbacks"), "fit.capture"),
            "serve": ("serve.request", "serve.request", ("serve.replay",),
                      "serve.capture")}


def host_metric(spans, kind, steps_per_root):
    """The host metric of the layer (the readers' definition) on spans
    recorded without the profiler, leaving out the roots that captured:
    host ms a step (train) or a request (serve)."""
    root_name, keep, cut, capture = HOST_CUT[kind]
    by_index = {s.index: s for s in spans}

    def root(s):
        while s.parent in by_index:
            s = by_index[s.parent]
        return s.trace if kind == "train" else s.index

    skip = {root(s) for s in spans if s.name == capture}
    spans = [s for s in spans if root(s) not in skip]
    roots = sum(1 for s in spans if s.name == root_name)
    if not roots:
        return None
    base = min(s.start_ns for s in spans)

    def iv(pick):
        return [(1e-9 * (s.start_ns - base), 1e-9 * (s.end_ns - base))
                for s in spans if pick(s.name)]

    own = pt.subtract(iv(lambda n: n.startswith(keep)),
                      iv(lambda n: n in cut))
    return 1e3 * pt.length(own) / (roots * steps_per_root)


def turns(workload, seed, seconds, order, device="cuda:0", spec=None,
          here=harness.ROOT):
    """The windows of one driver in ``order`` (each "on" or "off")."""
    spec = harness.load_spec() if spec is None else spec
    config, traffic, _, _, _ = harness.resolve(spec, workload, here)
    driver = harness.make_driver(config, traffic, seed, device)
    driver.setup()
    out = []
    for turn in order:
        tracing.clear()
        on = turn == "on"
        with tracing.record() if on else contextlib.nullcontext():
            w = driver.window(seconds)
        row = {"turn": turn, "seconds": w["seconds"],
               "rows_per_s": w["rows"] / w["seconds"]}
        if traffic["kind"] == "train":
            row["steps_per_s"] = w["attempted"] / w["seconds"]
        else:
            lat = 1e3 * np.asarray(w["latencies_s"])
            row.update(requests=len(lat), p50_ms=float(np.percentile(lat, 50)),
                       p95_ms=float(np.percentile(lat, 95)))
        if on:
            spans = tracing.spans()
            row["spans"] = span_stats(spans)
            row["host_metric_ms"] = host_metric(
                spans, traffic["kind"], traffic.get("chunk_steps", 1))
            if traffic["kind"] == "train":
                row["replay"] = replay_after_log(spans)
        out.append(row)
        print(json.dumps({"cell": workload, **{k: v for k, v in row.items()
                                               if k != "spans"}}),
              file=sys.stderr, flush=True)
    del driver
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


class _Stop(Exception):
    pass


def toggled(workload, seed, pairs, device="cuda:0"):
    """Rows of profiled stretches of one ``fit`` of a training cell, each
    one log interval, in the order on, off, off, on (``pairs`` times), the
    spans recording in the ``on`` stretches only."""
    config, traffic, _, _, _ = harness.resolve(harness.load_spec(), workload)
    driver = harness.make_driver(config, traffic, seed, device)
    driver.setup()
    plan = ["on", "off", "off", "on"] * pairs
    real = tracing._profiler
    blind = types.SimpleNamespace(_is_profiler_enabled=False)
    st = {"i": -1, "tracer": None, "warm": 0, "rows": []}

    def boundary(step, model, loss, stats):
        if st["warm"] < 5:                  # past the capture's first reads
            st["warm"] += 1
            return
        tracer = st["tracer"]
        if tracer is not None:
            tracer.boundary(1e9, step, step)
            if tracer.state != "done":
                return
            t = tracer.result()
            replay = [1e-6 * (s.end_ns - s.start_ns) for s in tracing.spans()
                      if s.name == "fit.replay"]
            row = {"cell": workload, "turn": plan[st["i"]], "steps": t.units,
                   "idle_pct": 100 * (1 - t.busy_s / t.span_s),
                   "stretch_ms": 1e3 * t.span_s,
                   "kernels_per_step": sum(1 for n, _, _ in t.ops
                                           if is_kernel(n)) / max(t.units, 1),
                   "longest_gap_ms": 1e3 * max((b - a for a, b in t.gaps),
                                               default=0.0),
                   "replay_ms": replay}
            st["rows"].append(row)
            print(json.dumps({k: v for k, v in row.items()
                              if k != "replay_ms"}), file=sys.stderr,
                  flush=True)
        st["i"] += 1
        if st["i"] >= len(plan):
            raise _Stop
        # the spans see no profiler in the "off" stretches
        tracing._profiler = real if plan[st["i"]] == "on" else blind
        tracing.clear()
        st["tracer"] = Tracer(0.0, 0.0)
        st["tracer"].boundary(0.0, step, step)

    try:
        port.fit(driver.model, 10 ** 12,
                 learning_rate=config["learning_rate"],
                 batch_size=config["minibatch"], seed=seed,
                 callbacks=[boundary], log_every=traffic["log_every"],
                 scan_steps=traffic["chunk_steps"])
    except _Stop:
        pass
    finally:
        tracing._profiler = real
    del driver
    torch.cuda.empty_cache()
    return st["rows"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--turns", default="off,on,on,off")
    p.add_argument("--toggle", type=int, default=0,
                   help="pairs of on/off stretches instead of the rest")
    p.add_argument("--out")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    harness.build_kernels()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    order = [t for t in args.turns.split(",") if t]
    for k, workload in enumerate(args.workload.split(",")):
        seed = args.seed + k
        if args.toggle:
            rows = toggled(workload, seed, args.toggle)
            line = {"cell": workload, "seed": seed,
                    "device": torch.cuda.get_device_name(0), "toggle": rows}
            for turn in ("on", "off"):
                idle = [r["idle_pct"] for r in rows if r["turn"] == turn]
                line[f"idle_pct_{turn}_median"] = statistics.median(idle)
            text = json.dumps(line)
            print(text, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(text + "\n")
            continue
        result, phases, attr = traced(workload, seed, args.seconds)
        line = {"cell": workload, "seed": seed,
                "device": torch.cuda.get_device_name(0),
                "metrics": {k: v["value"] for k, v in
                            result["metrics"].items()},
                "correct": result["correct"], "busy_s":
                result["device"].get("busy_s"), "window_s":
                result["device"].get("window_s"), "set_up": phases,
                "attribution": attr,
                "turns": turns(workload, seed + 1000, args.seconds, order)}
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
