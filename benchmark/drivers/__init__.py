"""The traffic drivers, one module a traffic ``kind``, each with a class
``Driver(config, traffic, seed, device, system, reference)``:

- ``setup()``: builds what the window drives, from the seed;
- ``window(seconds, tracer=None)``: drives it and returns {"start" (the
  host clock at the window's start), "seconds", "attempted", "failed",
  "rows", "latencies_s"}, calling ``tracer.boundary(elapsed, units,
  rows)`` where the host has synchronized with the device;
- ``release()``: frees the program's state;
- ``check()`` and ``control()``: the compared numbers of the program, and
  of the reference in float32 with TF32 products in its place, against
  the float64 reference (``compare.py``).

``system`` and ``reference`` are the modules that the configuration names.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch


class Driver:
    def __init__(self, config, traffic, seed, device, system, reference):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.system, self.reference = system, reference
        self.phases = {}

    @contextmanager
    def phase(self, name):
        """Times a step of set-up (host clock, ending in a synchronize)
        into ``phases``, which the run prints to standard error."""
        t = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.phases[name] = time.perf_counter() - t

    def build(self):
        """The inputs made from the seed, and the port's model."""
        with self.phase("data"):
            self.inputs = self.system.make_inputs(self.config, self.seed,
                                                  self.device)
        with self.phase("build"):
            return self.system.build_model(self.config, self.inputs,
                                           self.device)
