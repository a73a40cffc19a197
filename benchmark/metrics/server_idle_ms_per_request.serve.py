"""server_idle_ms_per_request.serve: device-idle milliseconds a request
inside the server: the overlap of the traced stretch's idle gaps
(``Trace.gaps``, the union that ``device_idle_share.serve`` reads) with
the port's ``serve.request`` spans, over the stretch's requests.  The
spans are placed on the stretch by ``program_trace.place``."""

from benchmark import program_trace as pt


def read(ctx):
    t = ctx.trace
    if ctx.traffic["kind"] != "serve" or t is None or t.units == 0:
        return None
    placed = pt.place(t, "serve")
    if placed is None:
        return None
    own = placed.intervals(lambda n: n == "serve.request")
    return 1e3 * pt.overlap(t.gaps, own) / t.units
