"""device_idle_share.train: the share of the traced stretch in which no
operation (kernel, copy or memset) ran on the device: one minus the union
of the device operations' intervals over the stretch's wall span, in
percent."""


def read(ctx):
    t = ctx.trace
    if ctx.traffic["kind"] != "train" or t is None or t.span_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.span_s)
