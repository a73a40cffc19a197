"""fused_bwd_roofline.train: the fused conditional's backward in the
traced stretch of a training cell (its row pass, reduction and slice sum,
``fused_conditional_bwd*`` and ``sum_slices_kernel``): the sum of each
call's least time on the H100 (``yardstick.conditional_least_s`` with
``backward``, operations counted with the gram saved whatever the route)
over the device time of those kernels, in percent.  Calls are counted by
their row-pass launches, one a layer a step; a call the profiler lost
counts at the mean of the layers' least times."""

from benchmark import yardstick

ROWS = "fused_conditional_bwd_rows_kernel"
KERNELS = ("fused_conditional_bwd", "sum_slices_kernel")


def read(ctx):
    t = ctx.trace
    if ctx.traffic["kind"] != "train" or t is None:
        return None
    calls = sum(1 for name, _, _ in t.ops if ROWS in name)
    busy = sum(end - start for name, start, end in t.ops
               if any(k in name for k in KERNELS))
    if calls == 0 or busy <= 0:
        return None
    c = ctx.config
    B = min(c["minibatch"], c["data"]["train_rows"]) * c["num_samples"]
    least = [yardstick.conditional_least_s(B, c["num_inducing"], Dx, Do,
                                           backward=True)
             for Dx, Do in yardstick.layer_widths(c)]
    return 100.0 * calls * (sum(least) / len(least)) / busy
