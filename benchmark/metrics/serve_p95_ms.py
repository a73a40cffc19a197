"""serve_p95_ms: the 95th percentile of the latency of every request in
the window, each timed on the host clock from the call to ``serve`` until
its outputs are in host memory (from when it was due, in an open loop).
numpy's linear interpolation between order statistics."""

import numpy as np


def read(ctx):
    if ctx.traffic["kind"] != "serve" or not ctx.window["latencies_s"]:
        return None
    return 1e3 * float(np.percentile(ctx.window["latencies_s"], 95))
