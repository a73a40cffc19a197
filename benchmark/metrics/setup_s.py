"""setup_s: seconds from the process's start to the window's start (host
clock): imports, the kernels' build where they are not built yet, data,
weights, the model and the captures, and the check's first chunks."""


def read(ctx):
    return ctx.window["setup_s"]
