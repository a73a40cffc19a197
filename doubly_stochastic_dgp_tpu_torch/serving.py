"""Serving: a one-call request path over a trained model, and exported
prediction programs.

Counterpart of ``doubly_stochastic_dgp_tpu/serving.py`` (``make_server``,
``export_fn``, ``load_exported``, ``export_predict_y``).  Every request
runs under ``torch.no_grad()``.
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

Export: ``export_predict_y`` traces ``predict_y`` with ``torch.export``
into a program that takes X and the unit normals of every layer (in place
of the JAX key) and holds the parameters as its lifted inputs; the CUDA
kernels' forward launches are the registered ops ``torch.ops.dsdgp.*``,
so a program saved with ``torch.export.save`` loads (``load_exported``)
in a process that has imported only ``doubly_stochastic_dgp_tpu_torch.
ops.cuda`` and runs the kernels on the card.  A loaded program takes
refreshed parameters (a state dict of the exported model) without a new
export.
"""

from __future__ import annotations

import itertools
from typing import Optional

import numpy as np
import torch

from .graphs import CapturedCall, DrawTape, graphs_enabled
from .tracing import count, span

__all__ = ["make_server", "derive_seed", "GraphedRequests", "export_fn",
           "load_exported", "export_predict_y"]


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


class GraphedRequests:
    """``fn(X, Y, generator)`` (Y may be None) run eagerly on the CPU and
    inside ``graphs.eager_on_card()``, and on the card as one CUDA graph
    captured per (X shape, Y shape) at its first request and replayed
    after: the request's inputs are copied into the graph's static inputs
    and its draws made from ``generator`` into the tape's buffers in the
    eager order; the outputs are cloned.  ``captured`` maps each captured
    shape to (static X, static Y, tape, ``CapturedCall``).  The graphs
    share one memory pool, which holds the largest captured request's
    intermediates and every captured shape's outputs: requests replay one
    at a time, each replay's outputs are cloned before the next, and the
    static inputs and the tapes' buffers are allocated outside the
    captures, so a graph may reuse what another graph's capture freed."""

    def __init__(self, fn, device, what):
        self.fn, self.device, self.what = fn, torch.device(device), what
        self.captured = {}
        self.pool = None

    def _capture(self, key, Xb, Yb):
        sX, sY = Xb.clone(), None if Yb is None else Yb.clone()
        tape = DrawTape(torch.Generator(device=self.device))

        def warmup():
            self.fn(sX, sY, tape)
            tape.freeze()

        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        self.captured[key] = sX, sY, tape, CapturedCall(
            lambda: self.fn(sX, sY, tape), warmup,
            f"{self.what} request of shape {key}", pool=self.pool)

    def __call__(self, Xb, Yb, generator):
        if not graphs_enabled(self.device):
            with span("serve.eager"):
                return self.fn(Xb, Yb, generator)
        key = (tuple(Xb.shape), None if Yb is None else tuple(Yb.shape))
        if key not in self.captured:
            with span("serve.capture"):
                self._capture(key, Xb, Yb)
        sX, sY, tape, call = self.captured[key]
        with span("serve.draws"):
            tape.fill(generator)
        with span("serve.replay"):
            sX.copy_(Xb)
            if sY is not None:
                sY.copy_(Yb)
            out = call.replay()
        with span("serve.output"):
            return _map(torch.clone, out)


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
    outputs; each shape also keeps its static inputs and normals
    (:class:`GraphedRequests`).

    Each call is a ``serve.request`` span (``tracing.py``), its trace id
    the call's index (the warm-up's first), with children ``serve.input``
    (the host rows to the device), ``serve.seed`` (the seed and the
    request's generator), ``serve.pad`` and ``serve.concat`` (buckets),
    and on the card ``serve.capture``, ``serve.draws``, ``serve.replay``
    (the static inputs' copies and the replay) and ``serve.output`` (the
    outputs' clones), elsewhere ``serve.eager``; and adds to the counters
    ``serve.requests``, ``serve.rows`` and ``serve.padded_rows``."""
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

    requests = GraphedRequests(_eager, device, method)
    calls = itertools.count()

    def _generator(seed, chunk=None):
        # the seed as given (for a chunk of a split request, derived from
        # it and the chunk's index), else the server's next
        with span("serve.seed"):
            if seed is None:
                seed = derive_seed(base_seed, next(counter))
            elif chunk is not None:
                seed = derive_seed(seed, chunk)
            g = torch.Generator(device=device)
            g.manual_seed(seed)
        return g

    def _pad_rows(A, pad):
        return torch.nn.functional.pad(A, (0, 0, 0, pad))

    def _cut(out, n):
        return _map(lambda t: _rows(t, n), out)

    @torch.no_grad()
    def serve(X, Y=None, seed=None):
        with span("serve.request", trace=next(calls)):
            return _serve(X, Y, seed)

    def _serve(X, Y, seed):
        with span("serve.input"):
            X = torch.as_tensor(X, dtype=dtype, device=device)
            if needs_y:
                if Y is None:
                    raise ValueError("predict_density requests need Y")
                Y = torch.as_tensor(Y, dtype=dtype, device=device)
        B = X.shape[0]
        count("serve.requests")
        count("serve.rows", B)
        if buckets is None:
            return requests(X, Y, _generator(seed))
        top = buckets[-1]
        outs = []
        for chunk_idx, start in enumerate(range(0, B, top)):
            n = min(top, B - start)
            bb = next(b for b in buckets if n <= b)
            with span("serve.pad"):
                Xb = _pad_rows(X[start:start + n], bb - n)
                Yb = _pad_rows(Y[start:start + n], bb - n) if needs_y else None
            count("serve.padded_rows", bb - n)
            g = _generator(seed, chunk_idx if B > top else None)
            outs.append((requests(Xb, Yb, g), n))
        with span("serve.concat"):
            chunks = [_cut(out, n) for out, n in outs]
            if len(chunks) == 1:
                return chunks[0]
            if isinstance(chunks[0], tuple):
                return tuple(torch.cat(parts,
                                       dim=-2 if parts[0].ndim >= 2 else 0)
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
    serve.captured = requests.captured
    return serve


def export_fn(module, *example_args, path: Optional[str] = None):
    """``torch.export.export`` of ``module`` (an ``nn.Module`` whose
    ``forward`` takes the example arguments) at the example arguments'
    shapes; writes it to ``path`` with ``torch.export.save`` if given.
    Returns the ``ExportedProgram``."""
    program = torch.export.export(module, tuple(example_args), strict=False)
    if path is not None:
        torch.export.save(program, path)
    return program


class _PredictY(torch.nn.Module):
    """``model.predict_y(X, S, zs)`` as a module: the parameters are the
    model's, the draws an argument (one (S, B, D_l) tensor a layer)."""

    def __init__(self, model, S):
        super().__init__()
        self.model, self.S = model, int(S)

    def forward(self, X, *zs):
        return self.model.predict_y(X, S=self.S, zs=list(zs))


def predict_y_draws(model, batch_size: int, S: int, generator=None):
    """Unit normals for an exported ``predict_y`` of ``model``: one (S,
    batch_size, D_l) tensor a layer, drawn from ``generator`` (zeros
    without one) on the model's device."""
    like = model.X_data
    shapes = [(S, batch_size, layer.num_outputs) for layer in model.layers]
    if generator is None:
        return [like.new_zeros(s) for s in shapes]
    return [torch.randn(s, generator=generator, dtype=like.dtype,
                        device=like.device) for s in shapes]


def export_predict_y(model, batch_size: int, S: int,
                     path: Optional[str] = None, precomputed: bool = False):
    """Export ``model.predict_y`` at a fixed batch size and sample count:
    the program takes (X, *zs), the draws of :func:`predict_y_draws`, and
    returns (mean, var), each (S, batch_size, D_Y).  ``precomputed=True``
    exports the posterior cache (``models.posterior.precompute``), so the
    program holds no Cholesky.  Returns the ``ExportedProgram`` (saved to
    ``path`` if given)."""
    if precomputed:
        from .models.posterior import precompute
        model = precompute(model)
    X = torch.zeros(batch_size, model.X_data.shape[1],
                    dtype=model.X_data.dtype, device=model.X_data.device)
    return export_fn(_PredictY(model, S), X,
                     *predict_y_draws(model, batch_size, S), path=path)


def load_exported(path_or_program):
    """A callable ``call(X, zs, state=None)`` running a saved (or given)
    exported program; ``state``: refreshed parameters and buffers, a
    ``state_dict()`` of a model of the exported structure (the cached
    model, for a ``precomputed`` export).  ``call.program`` is the
    ``ExportedProgram``."""
    program = path_or_program
    if not isinstance(program, torch.export.ExportedProgram):
        program = torch.export.load(path_or_program)
    module = program.module()

    def call(X, zs, state=None):
        if state is None:
            return module(X, *zs)
        return torch.func.functional_call(
            module, {f"model.{k}": v for k, v in state.items()}, (X, *zs))

    call.program = program
    return call
