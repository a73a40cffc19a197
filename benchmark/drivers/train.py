"""``"kind": "train"``: ``fit`` itself, a closed loop of training steps.

The window is one call of the port's ``fit(model, iterations=<large>,
learning_rate, batch_size=<the configuration's minibatch>, seed,
log_every, scan_steps=chunk_steps)``: Adam in chunks of ``chunk_steps``
steps, each one captured CUDA graph on the card, the loss read on the host
every ``log_every`` steps, where ``fit`` calls its callbacks.  The
harness's callback marks the window's start at the first of those reads
that comes ``warmup_seconds`` or more after the first chunk (the capture)
returned, and ends the window, by raising, at the first read at or after
its seconds; so both ends are at a loss that ``fit`` has read.

``fit`` hands neither its optimizer nor its chunk to anyone, and the
check needs both, so while it runs the harness wraps the factory that
``fit`` calls for its chunk (``training.loop.make_scan_train_step``): the
wrapper keeps the optimizer ``fit`` passes in and returns the chunk it
made, observed.  The first ``check_chunks`` calls of that chunk, taken
before the window starts, give the check's numbers (each chunk's mean
loss, Adam's first moment after the first, the parameters after the
last); the wrapper changes no value, and its later calls only wrap the
chunk in a ``record_function`` span.
"""

from __future__ import annotations

import math
import time
from contextlib import contextmanager

import torch
from torch.profiler import record_function

from benchmark import compare
from benchmark.drivers import Driver as _Driver
from benchmark.seeds import derived_seed

ITERATIONS = 10 ** 12           # more steps than any window takes


class _Closed(Exception):
    """Raised by the callback to end ``fit`` at the window's end."""


class _Observed:
    """``fit``'s chunk, whose first ``k`` calls are read for the check."""

    def __init__(self, chunk, optimizer, names, k):
        self._chunk, self._optimizer = chunk, optimizer
        self._names, self._k = names, k
        self.losses, self.moments, self.after = [], None, None
        self.captured_at = None

    def __call__(self, model, generator=None):
        with record_function("bench.chunk"):
            loss = self._chunk(model, generator=generator)
        if len(self.losses) < self._k:
            self.losses.append(float(loss))
            if len(self.losses) == 1:
                self.captured_at = time.perf_counter()
                self.moments = {n: m.detach().clone() for n, m in
                                zip(self._names, self._optimizer.state.mu)}
            if len(self.losses) == self._k:
                self.after = {n: p.detach().clone() for n, p in
                              zip(self._names, self._optimizer.params)}
        return loss

    def __getattr__(self, name):
        return getattr(self._chunk, name)


class Driver(_Driver):
    def setup(self):
        self.model = self.build()
        leaves = self.system.trainable_leaves(self.model)
        self.leaves = leaves
        self.init = {n: p.detach().clone() for n, p in leaves.items()}
        self.fit_seed = derived_seed(self.seed, "train")
        N = self.inputs["data"]["X"].shape[0]
        self.batch = min(self.config["minibatch"], N)
        self.observed = None

    @contextmanager
    def _observing(self):
        """``training.loop.make_scan_train_step`` wrapped while ``fit``
        runs (the factory as found then, so a fault planted under it is
        kept)."""
        from doubly_stochastic_dgp_tpu_torch.training import loop
        make = loop.make_scan_train_step
        names, ids = list(self.leaves), [id(p) for p in self.leaves.values()]

        def observed(optimizer, *args, **kwargs):
            if [id(p) for p in optimizer.params] != ids:
                raise RuntimeError("fit's optimizer does not hold the "
                                   "model's trainable parameters in order")
            self.observed = _Observed(make(optimizer, *args, **kwargs),
                                      optimizer, names,
                                      self.traffic["check_chunks"])
            return self.observed

        loop.make_scan_train_step = observed
        try:
            yield
        finally:
            loop.make_scan_train_step = make

    def window(self, seconds, tracer=None):
        import doubly_stochastic_dgp_tpu_torch as port
        t = self.traffic
        log_every = t["log_every"]
        w = {"start": None, "step0": 0, "steps": 0, "failed": 0}

        def boundary(step, model, loss, stats):
            now = time.perf_counter()
            if w["start"] is None:
                if self.observed is None or self.observed.after is None:
                    raise RuntimeError(
                        f"fit read its first loss before {t['check_chunks']}"
                        f" chunks of its own were observed")
                if now - self.observed.captured_at >= t["warmup_seconds"]:
                    w["start"], w["step0"] = now, step
                return
            w["steps"] = step - w["step0"]
            if not math.isfinite(loss):
                w["failed"] += log_every
            elapsed = now - w["start"]
            if tracer is not None:
                tracer.boundary(elapsed, w["steps"], w["steps"] * self.batch)
            if elapsed >= seconds:
                w["end"] = now
                raise _Closed

        with self._observing():
            try:
                port.fit(self.model, ITERATIONS,
                         learning_rate=self.config["learning_rate"],
                         batch_size=self.config["minibatch"],
                         seed=self.fit_seed, callbacks=[boundary],
                         log_every=log_every, scan_steps=t["chunk_steps"])
            except _Closed:
                pass
        return {"start": w["start"], "seconds": w["end"] - w["start"],
                "attempted": w["steps"], "failed": w["failed"],
                "rows": w["steps"] * self.batch, "latencies_s": []}

    def release(self):
        o = self.observed
        self.program = {"chunk_losses": o.losses, "moments": o.moments,
                        "init": self.init, "after": o.after}
        del self.model, self.leaves, self.observed

    def _side(self, dtype=torch.float64, tf32=False):
        return self.reference.train_side(self.config, self.traffic,
                                         self.inputs, self.fit_seed, dtype,
                                         tf32)

    def check(self):
        return compare.train_numbers(self.program, self._side())

    def control(self):
        return compare.train_numbers(self._side(torch.float32, True),
                                     self._side())
