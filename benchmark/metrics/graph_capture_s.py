"""graph_capture_s: the port's ``graph.capture_s`` counter after the
window: host seconds of the eager warm-up and the capture of every CUDA
graph the process made (``graphs.CapturedCall``: the train chunk, or the
server's request), which set-up pays.  None where the port has no such
counter or captured nothing."""


def read(ctx):
    try:
        from doubly_stochastic_dgp_tpu_torch import tracing
    except ImportError:
        return None
    c = tracing.counters()
    if not c.get("graph.captures"):
        return None
    return float(c["graph.capture_s"])
