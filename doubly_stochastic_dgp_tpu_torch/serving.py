"""Serving: a one-call request path over a trained model.

Counterpart of ``doubly_stochastic_dgp_tpu/serving.py::make_server``
without ``jax.export``.  Every request runs under ``torch.no_grad()``.
On a CUDA tensor each request shape (each bucket, or without buckets
each new shape at its first request, as jit caches per shape) is
captured once as a CUDA graph (``graphs.CapturedCall``) and replayed per
request, with no host sync inside it; on the CPU, and on the card inside
``graphs.eager_on_card()``, the request runs eagerly.

Random draws: each request gets its own ``torch.Generator`` on the
model's device.  Without a caller seed it is seeded from the server's
base seed and an internal counter; a pinned ``seed=`` is used as given
for a single chunk and, for a request split into chunks, derived per
chunk from (seed, chunk index), so identical pinned requests reproduce
bit for bit.  A graphed request's normals are drawn from that generator
before the replay, in the eager order (``graphs.DrawTape``), so it
returns the eager answer.  The JAX package's keys and this package's
generators give different numbers.
"""

from __future__ import annotations

import itertools
from typing import Optional

import numpy as np
import torch

from .graphs import CapturedCall, DrawTape, graphs_enabled

__all__ = ["make_server", "derive_seed"]


def derive_seed(base: int, index: int) -> int:
    """A 63-bit seed derived from (base, index), the counterpart of
    ``jax.random.fold_in``."""
    state = np.random.SeedSequence([int(base), int(index)]).generate_state(
        1, np.uint64)[0]
    return int(state) & (2 ** 63 - 1)


def _map(f, out):
    return tuple(f(o) for o in out) if isinstance(out, tuple) else f(out)


def _rows(t, n):
    # request outputs carry rows on axis -2 ((S, B, D) moments, (B, D)
    # densities); 1-D outputs on axis 0
    return t.narrow(-2 if t.ndim >= 2 else 0, 0, n)


def make_server(model, S: int, *, method: str = "predict_y",
                precompute: bool = True, warmup_batch: Optional[int] = None,
                seed: Optional[int] = None, batch_buckets=None):
    """Serving callable ``serve(X[, Y], seed=None)`` returning
    ``model.<method>(X[, Y], S=S)``.

    ``method`` is ``'predict_y'`` (requests ``serve(X)``) or
    ``'predict_density'`` (requests ``serve(X, Y)``).  ``precompute``
    first maps the model through the posterior cache.  ``batch_buckets``
    (ascending row counts) right-pads each request to the smallest
    covering bucket and slices the outputs back; requests above the top
    bucket are served in top-bucket chunks and concatenated.  For a
    Monte-Carlo model the padded shape takes part in the draw, so a
    bucketed answer equals a same-shape padded call, not an unpadded
    one.  ``warmup_batch`` (or every bucket) is served once before
    returning, which on the card captures its graph.  ``serve.captured``
    maps each captured (X shape, Y shape) to (static X, static Y, tape,
    ``CapturedCall``).  The graphs share one memory pool, which holds the
    largest captured request's intermediates and every captured shape's
    outputs; each shape also keeps its static inputs and normals."""
    if method not in ("predict_y", "predict_density"):
        raise ValueError(f"method must be 'predict_y' or 'predict_density'; "
                         f"got {method!r}")
    D_in = int(model.X_data.shape[1])
    D_out = int(model.Y_data.shape[1])
    device, dtype = model.X_data.device, model.X_data.dtype
    if precompute:
        from .models.posterior import precompute as _precompute
        model = _precompute(model)
    needs_y = method == "predict_density"
    bound = getattr(model, method)
    base_seed = 0 if seed is None else int(seed)
    counter = itertools.count()
    buckets = (tuple(sorted({int(b) for b in batch_buckets}))
               if batch_buckets else None)

    def _eager(Xb, Yb, g):
        if needs_y:
            return bound(Xb, Yb, S=S, generator=g)
        return bound(Xb, S=S, generator=g)

    # (X shape, Y shape) -> (static X, static Y, tape, CapturedCall)
    captured = {}
    # one memory pool for all of the server's graphs: requests replay one
    # at a time, each replay's outputs are cloned before the next, and the
    # static inputs and the tapes' buffers are allocated outside the
    # captures, so a graph may reuse what another graph's capture freed
    pool = []

    def _capture(key, Xb, Yb):
        sX, sY = Xb.clone(), None if Yb is None else Yb.clone()
        tape = DrawTape(torch.Generator(device=device))

        def warmup():
            _eager(sX, sY, tape)
            tape.freeze()

        if not pool:
            pool.append(torch.cuda.graph_pool_handle())
        captured[key] = sX, sY, tape, CapturedCall(
            lambda: _eager(sX, sY, tape), warmup,
            f"{method} request of shape {key}", pool=pool[0])

    def _call(Xb, Yb, s):
        g = torch.Generator(device=device)
        g.manual_seed(s)
        if not graphs_enabled(device):
            return _eager(Xb, Yb, g)
        key = (tuple(Xb.shape), None if Yb is None else tuple(Yb.shape))
        if key not in captured:
            _capture(key, Xb, Yb)
        sX, sY, tape, call = captured[key]
        sX.copy_(Xb)
        if sY is not None:
            sY.copy_(Yb)
        tape.fill(g)
        return _map(torch.clone, call.replay())

    def _next_seed():
        return derive_seed(base_seed, next(counter))

    def _pad_rows(A, pad):
        return torch.nn.functional.pad(A, (0, 0, 0, pad))

    @torch.no_grad()
    def serve(X, Y=None, seed=None):
        X = torch.as_tensor(X, dtype=dtype, device=device)
        if needs_y:
            if Y is None:
                raise ValueError("predict_density requests need Y")
            Y = torch.as_tensor(Y, dtype=dtype, device=device)
        if buckets is None:
            return _call(X, Y, seed if seed is not None else _next_seed())
        B = X.shape[0]
        top = buckets[-1]
        chunks = []
        for chunk_idx, start in enumerate(range(0, B, top)):
            n = min(top, B - start)
            bb = next(b for b in buckets if n <= b)
            Xb = _pad_rows(X[start:start + n], bb - n)
            Yb = _pad_rows(Y[start:start + n], bb - n) if needs_y else None
            if seed is not None:
                s = seed if B <= top else derive_seed(seed, chunk_idx)
            else:
                s = _next_seed()
            out = _call(Xb, Yb, s)
            chunks.append(_map(lambda t: _rows(t, n), out))
        if len(chunks) == 1:
            return chunks[0]
        if isinstance(chunks[0], tuple):
            return tuple(torch.cat(parts, dim=-2 if parts[0].ndim >= 2 else 0)
                         for parts in zip(*chunks))
        return torch.cat(chunks, dim=-2 if chunks[0].ndim >= 2 else 0)

    for b in (buckets or (warmup_batch,)):
        if not b:
            continue
        x0 = torch.zeros(b, D_in, dtype=dtype, device=device)
        if needs_y:
            serve(x0, torch.zeros(b, D_out, dtype=dtype, device=device))
        else:
            serve(x0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    serve.captured = captured
    return serve
