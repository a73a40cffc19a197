"""mfu.train: the model operations of the traced stretch's training steps
(``yardstick.train_step_flops``, counted from the shapes) over the
stretch's seconds times the H100's fp32 peak, in percent."""

from benchmark import yardstick


def read(ctx):
    t = ctx.trace
    if ctx.traffic["kind"] != "train" or t is None or t.units == 0:
        return None
    batch = min(ctx.config["minibatch"], ctx.config["data"]["train_rows"])
    flops = yardstick.train_step_flops(ctx.config, batch) * t.units
    return 100.0 * flops / (t.span_s * yardstick.FP32_PEAK)
