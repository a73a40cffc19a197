"""mfu.serve: the model operations of the traced stretch's requests (the
cached forward at B = samples x rows a layer, ``yardstick.
cached_forward_flops``) over the stretch's seconds times the H100's fp32
peak, in percent."""

from benchmark import yardstick


def read(ctx):
    t = ctx.trace
    if ctx.traffic["kind"] != "serve" or t is None or t.units == 0:
        return None
    flops = yardstick.cached_forward_flops(ctx.config, t.rows,
                                           ctx.traffic["samples"])
    return 100.0 * flops / (t.span_s * yardstick.FP32_PEAK)
