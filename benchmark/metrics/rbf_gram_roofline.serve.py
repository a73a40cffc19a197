"""rbf_gram_roofline.serve: the RBF gram kernel's launches in the traced
stretch of a serving cell (``rbf_gram_kernel`` and ``rbf_gram_kernel_
wide``; through the posterior cache a request launches one a layer, K(Z,
X) at B = samples x rows): the sum of each launch's least time on the H100
(``yardstick.gram_least_s``) over the sum of their device times, in
percent.  A launch the profiler lost counts at the mean of the layers'
least times."""

from benchmark import yardstick

KERNEL = "rbf_gram_kernel"


def read(ctx):
    t = ctx.trace
    if ctx.traffic["kind"] != "serve" or t is None or t.units == 0:
        return None
    found = [end - start for name, start, end in t.ops
             if KERNEL in name]
    if not found:
        return None
    c = ctx.config
    B = (t.rows // t.units) * ctx.traffic["samples"]
    least = [yardstick.gram_least_s(c["num_inducing"], B, Dx)
             for Dx, _ in yardstick.layer_widths(c)]
    return 100.0 * len(found) * (sum(least) / len(least)) / sum(found)
