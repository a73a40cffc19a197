"""trainer_host_ms_per_step.train: host milliseconds a training step in
the port's ``fit.*`` spans within the traced stretch, less the time in
``fit.replay`` (the graph's launch, which a full launch queue holds and
the profiler slows per node), ``fit.sync`` (the host's wait for the loss)
and ``fit.callbacks`` (the caller's), over the stretch's steps: the
trainer's own host work around the launch (the tape's draws, the loss's
clone, the log event, the chunk's bookkeeping).  The spans are placed on
the stretch by ``program_trace.place``."""

from benchmark import program_trace as pt


def read(ctx):
    t = ctx.trace
    if ctx.traffic["kind"] != "train" or t is None or t.units == 0:
        return None
    placed = pt.place(t, "train")
    if placed is None:
        return None
    own = pt.subtract(
        placed.intervals(lambda n: n.startswith("fit.")),
        placed.intervals(lambda n: n in ("fit.replay", "fit.sync",
                                         "fit.callbacks")))
    return 1e3 * pt.overlap(own, [(0.0, t.span_s)]) / t.units
