"""Monitoring callbacks for ``fit``: iteration rate, scalar logs (JSONL,
and TensorBoard where it is installed), the full-data ELBO, and a
``torch.profiler`` trace.

Counterpart of ``doubly_stochastic_dgp_tpu/training/monitor.py``.  A
callback is ``cb(step, model, loss, stats)``; ``fit`` calls it after a
chunk whose end falls on a ``log_every`` boundary, after it has read the
chunk's loss on the host, so between replays of a captured chunk: a
callback may read the model and sync.  ``profile_trace`` writes a
profile with the port's spans merged in.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import torch

from .. import tracing

__all__ = ["PrintTimings", "JsonlLogger", "TensorBoardLogger",
           "FullElboCallback", "profile_trace"]


class PrintTimings:
    """Prints the loss and the iteration rate at each log event."""

    def __init__(self, prefix: str = ""):
        self.prefix = prefix

    def __call__(self, step, model, loss, stats):
        print(f"{self.prefix}iter {step}: loss {loss:.4f} "
              f"({stats['iters_per_sec']:.2f} it/s)", flush=True)


class JsonlLogger:
    """Appends one JSON object a log event to ``path`` (the stats and the
    step).  Close it when done."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def __call__(self, step, model, loss, stats):
        rec = dict(stats)
        rec["step"] = step
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


class TensorBoardLogger:
    """TensorBoard scalars through ``torch.utils.tensorboard``, imported
    here, not with the module, so the package does not need TensorBoard."""

    def __init__(self, logdir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            raise ImportError(
                "TensorBoardLogger needs the 'tensorboard' package, which "
                "torch.utils.tensorboard imports and which is not "
                "installed; JsonlLogger writes the same scalars") from e
        self.writer = SummaryWriter(logdir)

    def __call__(self, step, model, loss, stats):
        self.writer.add_scalar("train/loss", loss, step)
        for k, v in stats.items():
            if isinstance(v, (int, float)) and k != "iter":
                self.writer.add_scalar(f"train/{k}", v, step)

    def close(self):
        self.writer.close()


class FullElboCallback:
    """The ELBO on the whole stored training set at each log event, into
    ``stats["full_elbo"]``.  Draws come from ``generator`` (advanced at
    each event) or, without one, from a generator on the model's device
    seeded 0 at each event (the JAX callback's fixed default key)."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        self.generator = generator

    @torch.no_grad()
    def __call__(self, step, model, loss, stats):
        g = self.generator
        if g is None:
            g = torch.Generator(device=model.X_data.device)
            g.manual_seed(0)
        stats["full_elbo"] = float(model.elbo(generator=g))


class profile_trace:
    """A ``torch.profiler`` profile (CPU, and CUDA where a card is
    present) around the block; on exit it writes a Chrome trace to
    ``logdir/trace.json``, and ``prof`` holds the profile.

    The port's spans (``tracing.py``) record while the profile runs; the
    written trace also holds those of the block, ``spans``, as a track of
    their own ("program spans") on the trace's time base, so the
    trainer's and the server's spans lie beside the kernels on one
    timeline, and the device's idle gaps beside the host work that left
    them.  The spans are merged from the port's ring, not emitted as
    profiler events, so they add no annotation to the device's timeline.

    The profiler loses the first records of a profile (on an H100: 16-17
    of 20 eager kernel launches kept, 46-47 of 50 in graph replays), so
    time a kernel over its own records (``key_averages()``: total device
    time over ``count``), never over the number of calls."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        self.prof = None
        self.spans = []

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t1 = time.time_ns()
        self.prof.__exit__(*exc)
        self.spans = [s for s in tracing.spans()
                      if s.end_ns >= self._t0 and s.start_ns <= t1]
        os.makedirs(self.logdir, exist_ok=True)
        path = os.path.join(self.logdir, "trace.json")
        self.prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
        trace["traceEvents"].extend(_chrome_events(
            self.spans, trace.get("baseTimeNanoseconds", 0)))
        with open(path, "w") as f:
            json.dump(trace, f)
        return False


def _chrome_events(spans, base_ns=0):
    """Chrome trace events of ``spans`` (``tracing.Span``): one complete
    event each on the "program spans" track of this process, its time in
    microseconds from ``base_ns`` (a Chrome trace's
    ``baseTimeNanoseconds``; ``time.time_ns()`` and the profiler's host
    events share a clock)."""
    pid = os.getpid()
    events = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
               "args": {"name": "program spans"}}]
    for s in spans:
        events.append({"ph": "X", "cat": "program_span", "name": s.name,
                       "pid": pid, "tid": 0,
                       "ts": (s.start_ns - base_ns) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {"index": s.index, "parent": s.parent,
                                "trace": s.trace}})
    return events
