"""``"kind": "serve"``: one client in a closed loop through ``make_server``.

Set-up builds the server (``samples`` draws, the posterior cache as
``precompute`` says, the ``rows``-row request captured) and sends
requests for ``warmup_seconds``: the first second or two of requests
after set-up run up to a quarter slower, and would otherwise set the
window's tail.  Each request is ``rows`` host float32 rows, taken in
turn from the seeded test set, timed from the call to ``serve`` until its
outputs are in host memory; the next is sent when the previous one is
there.  The window stops sending at its seconds and ends when the last
request is in host memory.  A reservoir drawn from the seed keeps
``check_requests`` of the window's requests for the check, their outputs
copied into host buffers made and touched in set-up: outputs kept in the
arrays the requests made would pin fresh host memory, and the requests
after each keep would pay for it inside the window.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import compare
from benchmark.drivers import Driver as _Driver
from benchmark.seeds import derived_seed


class Driver(_Driver):
    def setup(self):
        model = self.build()
        self.base_seed = derived_seed(self.seed, "serve")
        t = self.traffic
        with self.phase("server"):
            import doubly_stochastic_dgp_tpu_torch as port
            self.serve = port.make_server(
                model, S=t["samples"], precompute=t["precompute"],
                warmup_batch=t["rows"], seed=self.base_seed)
        del model
        self.index = 1          # the server's warm-up took index 0
        self.test = self.inputs["data"]["Xs"].cpu().numpy()
        self.rng = np.random.default_rng(derived_seed(self.seed, "requests"))
        self.cursor = 0
        with self.phase("warm-up requests"):
            start = time.perf_counter()
            host = self._request()[3]
            while time.perf_counter() - start < t["warmup_seconds"]:
                host = self._request()[3]
            self.slots = [tuple(np.ones_like(h) for h in host)
                          for _ in range(t["check_requests"])]
        self.cursor = 0

    def _request(self):
        """One request: (seconds, its index, X, host outputs)."""
        n = self.traffic["rows"]
        if self.cursor + n > self.test.shape[0]:
            self.cursor = 0
        X = self.test[self.cursor:self.cursor + n]
        self.cursor += n
        index, self.index = self.index, self.index + 1
        t = time.perf_counter()
        with record_function("bench.serve"):
            out = self.serve(X)
        with record_function("bench.host_copy"):
            host = tuple(o.cpu().numpy() for o in out)
        return time.perf_counter() - t, index, X, host

    def _keep(self, j, index, X, host):
        for dst, src in zip(self.slots[j], host):
            np.copyto(dst, src)
        self.kept[j] = (index, X)

    def window(self, seconds, tracer=None):
        k = self.traffic["check_requests"]
        self.kept = [None] * k
        latencies, rows, failed = [], 0, 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            try:
                lat, index, X, host = self._request()
            except RuntimeError:
                failed += 1
                continue
            latencies.append(lat)
            rows += X.shape[0]
            i = len(latencies) - 1
            j = i if i < k else int(self.rng.integers(i + 1))
            if j < k:
                self._keep(j, index, X, host)
            if tracer is not None:
                tracer.boundary(time.perf_counter() - t0, len(latencies),
                                rows)
        n = min(k, len(latencies))
        self.kept, self.slots = self.kept[:n], self.slots[:n]
        return {"start": t0, "seconds": time.perf_counter() - t0,
                "attempted": len(latencies) + failed, "failed": failed,
                "rows": rows, "latencies_s": latencies}

    def release(self):
        del self.serve

    def _reference(self, dtype, tf32):
        params, frozen = self.reference.posterior_params(
            self.config, self.inputs, dtype)
        return [self.reference.request_outputs(
            self.config, self.traffic, params, frozen, self.base_seed,
            index, X, dtype, tf32) for index, X in self.kept]

    def check(self):
        return compare.serve_numbers(self.slots,
                                     self._reference(torch.float64, False))

    def control(self):
        return compare.serve_numbers(self._reference(torch.float32, True),
                                     self._reference(torch.float64, False))
