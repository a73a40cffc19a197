"""train_rows_per_s: minibatch rows of every training step in the window
over the window's seconds (host clock, from one loss read to the first
loss read at or after the window's length)."""


def read(ctx):
    if ctx.traffic["kind"] != "train":
        return None
    return ctx.window["rows"] / ctx.window["seconds"]
