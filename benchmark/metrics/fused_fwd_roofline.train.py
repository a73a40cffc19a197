"""fused_fwd_roofline.train: the fused conditional's forward launches in
the traced stretch of a training cell: the sum of each launch's least time
on the H100 (``yardstick.conditional_least_s`` at the layer's B = batch x
samples, M, Dx, Do) over the sum of their device times, in percent.  Each
step launches the forward once a layer, in layer order; a launch the
profiler lost counts at the mean of the layers' least times."""

from benchmark import yardstick

KERNEL = "fused_conditional_fwd_kernel"


def read(ctx):
    t = ctx.trace
    if ctx.traffic["kind"] != "train" or t is None:
        return None
    found = [end - start for name, start, end in t.ops
             if KERNEL in name]
    if not found:
        return None
    c = ctx.config
    B = min(c["minibatch"], c["data"]["train_rows"]) * c["num_samples"]
    least = [yardstick.conditional_least_s(B, c["num_inducing"], Dx, Do)
             for Dx, Do in yardstick.layer_widths(c)]
    return 100.0 * len(found) * (sum(least) / len(least)) / sum(found)
