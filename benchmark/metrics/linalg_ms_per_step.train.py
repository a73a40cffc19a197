"""linalg_ms_per_step.train: device milliseconds a training step in the
cuBLAS and cuSOLVER triangular-solve, triangular-inverse and Cholesky
kernels of the traced stretch, matched by name (the patterns below, from
the kernel names of the first traced runs on the H100)."""

PATTERNS = ("trsm", "trsv", "potrf", "potrs", "trtri", "cholesky", "syrk",
            "herk")


def read(ctx):
    t = ctx.trace
    if ctx.traffic["kind"] != "train" or t is None or t.units == 0:
        return None
    busy = sum(end - start for name, start, end in t.ops
               if any(p in name.lower() for p in PATTERNS))
    if busy <= 0:
        return None
    return 1e3 * busy / t.units
