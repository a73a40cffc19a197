"""server_host_ms_per_request.serve: host milliseconds a request in the
port's ``serve.request`` spans of the traced stretch, less the time in
``serve.replay`` (the static inputs' copies and the graph's launch, which
the profiler slows per node): the server's own host work around the
launch (the rows to the device, the seed, the draws, the outputs'
clones), from the call to ``serve`` until it returns (the caller's copy
of the outputs is not in it)."""

from benchmark import program_trace as pt


def read(ctx):
    t = ctx.trace
    if ctx.traffic["kind"] != "serve" or t is None or t.units == 0:
        return None
    placed = pt.place(t, "serve")
    if placed is None:
        return None
    own = pt.subtract(placed.intervals(lambda n: n == "serve.request"),
                      placed.intervals(lambda n: n == "serve.replay"))
    return 1e3 * pt.length(own) / placed.roots
