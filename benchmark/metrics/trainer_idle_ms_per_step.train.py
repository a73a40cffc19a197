"""trainer_idle_ms_per_step.train: device-idle milliseconds a training
step inside the trainer's spans: the overlap of the traced stretch's idle
gaps (``Trace.gaps``, the union that ``device_idle_share.train`` reads)
with the port's ``fit.*`` spans less its ``fit.callbacks`` (time in the
callbacks is the caller's), over the stretch's steps.  The spans are
placed on the stretch by ``program_trace.place``."""

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
        placed.intervals(lambda n: n == "fit.callbacks"))
    return 1e3 * pt.overlap(t.gaps, own) / t.units
