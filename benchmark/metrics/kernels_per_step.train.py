"""kernels_per_step.train: device kernels (copies and memsets left out) in
the traced stretch over its training steps."""

from benchmark.tracing import is_kernel


def read(ctx):
    t = ctx.trace
    if ctx.traffic["kind"] != "train" or t is None or t.units == 0:
        return None
    return sum(1 for name, _, _ in t.ops if is_kernel(name)) / t.units
