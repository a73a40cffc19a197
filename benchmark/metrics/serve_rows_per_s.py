"""serve_rows_per_s: rows of every request completed in the window over
the window's seconds (host clock; the window ends when the last request
sent is in host memory)."""


def read(ctx):
    if ctx.traffic["kind"] != "serve":
        return None
    return ctx.window["rows"] / ctx.window["seconds"]
