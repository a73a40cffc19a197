"""Call-time sample counts over a fixed set of programs.

Counterpart of ``doubly_stochastic_dgp_tpu/models/dynamic.py``
(``DynamicPredictor``).  A prediction at S samples runs at the smallest
configured bucket B >= S and keeps the first S of the B i.i.d. samples;
an S above the largest bucket runs ceil(S / B_max) chunks of the largest
bucket under decorrelated generators and concatenates them.  On the card
each (method, bucket, X shape) is one CUDA graph captured at its first
request and replayed after (``serving.GraphedRequests``, the capture of
``make_server``), so a sweep over S in {1, 5, 25, 100} with the default
buckets (1, 8, 32, 128) captures four graphs a method, one a bucket; on
the CPU (and inside ``graphs.eager_on_card()``) each runs eagerly.
``trace_counts`` counts the programs set up per (method, bucket): the
captures on the card, the eager programs on the CPU.

Random draws: chunk c of a request draws from a generator seeded with the
request's ``seed`` (default 0) when the request is one chunk, else with
``serving.derive_seed(seed, c)``, as ``make_server`` does, so the kept
samples of a one-chunk request are the first S of ``make_server(model,
S=B, precompute=False)``'s at the same seed.  ``predict_density`` mixes
over exactly the S kept samples (logsumexp of their log densities less
log S).

The predictor serves its own copy of the model: ``update(model)`` copies
refreshed parameters of the same structure into it (the captured graphs
stay valid) and takes a model of another structure afresh (the graphs
are dropped).
"""

from __future__ import annotations

import copy
import math
from collections import Counter
from typing import Optional, Sequence

import torch

from ..serving import GraphedRequests, derive_seed

__all__ = ["DynamicPredictor"]


def _same_structure(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    return type(a) is type(b) and sa.keys() == sb.keys() and all(
        sa[k].shape == sb[k].shape and sa[k].dtype == sb[k].dtype
        for k in sa)


class DynamicPredictor:
    """S-bucketed prediction over a DGP-family model (any model with the
    ``DGPBase`` prediction surface: ``_predict`` and the per-sample
    y-space hooks).  ``buckets``: ascending sample counts."""

    def __init__(self, model, buckets: Sequence[int] = (1, 8, 32, 128)):
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"buckets must be positive ints, got {buckets}")
        self.model = copy.deepcopy(model)
        self.trace_counts: Counter = Counter()
        self._programs = {}

    def update(self, model):
        """Serve refreshed parameters: copied in place into the served
        model when ``model`` has its structure, else a fresh copy."""
        if _same_structure(self.model, model):
            with torch.no_grad():
                self.model.load_state_dict(model.state_dict())
        else:
            self.model = copy.deepcopy(model)
            self._programs = {}
        return self

    def _plan(self, S: int):
        """(bucket, chunks): the smallest bucket >= S, else chunks of the
        largest bucket."""
        if S < 1:
            raise ValueError(f"S must be >= 1, got {S}")
        for b in self.buckets:
            if b >= S:
                return b, 1
        b = self.buckets[-1]
        return b, -(-S // b)

    def _fn(self, kind, B):
        model = self.model

        def moments(X, g):
            return model._predict(X, generator=g, S=B)

        if kind == "f":
            return lambda X, Y, g: moments(X, g)
        if kind == "y":
            return lambda X, Y, g: model.sample_predict_y(*moments(X, g))
        if kind == "density":
            return lambda X, Y, g: model.sample_log_densities(
                *moments(X, g), Y)
        raise ValueError(kind)

    def _program(self, kind, B, X, Y):
        tag = (kind, B)
        if tag not in self._programs:
            self._programs[tag] = (GraphedRequests(
                self._fn(kind, B), X.device,
                f"DynamicPredictor {kind} S={B}"), set())
        program, shapes = self._programs[tag]
        key = (tuple(X.shape), None if Y is None else tuple(Y.shape))
        if key not in shapes:
            shapes.add(key)
            self.trace_counts[tag] += 1
        return program

    @torch.no_grad()
    def _run(self, kind, S, seed, X, Y=None):
        X = self.model._as_input(X)
        Y = None if Y is None else self.model._as_input(Y)
        B, chunks = self._plan(S)
        program = self._program(kind, B, X, Y)
        base = 0 if seed is None else int(seed)
        outs = []
        for c in range(chunks):
            g = torch.Generator(device=X.device)
            g.manual_seed(base if chunks == 1 else derive_seed(base, c))
            outs.append(program(X, Y, g))
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(parts)[:S] for parts in zip(*outs))
        return torch.cat(outs)[:S]

    def predict_f(self, Xnew, S: int, seed: Optional[int] = None):
        """(S, N, D) final-layer moments."""
        return self._run("f", S, seed, Xnew)

    def predict_y(self, Xnew, S: int, seed: Optional[int] = None):
        """(S, N, D) per-sample y-space moments."""
        return self._run("y", S, seed, Xnew)

    def predict_density(self, Xnew, Ynew, S: int,
                        seed: Optional[int] = None):
        """The Monte-Carlo mixture log density over exactly the S kept
        samples, (N, D)."""
        l = self._run("density", S, seed, Xnew, Ynew)
        return torch.logsumexp(l - math.log(S), dim=0)

    @property
    def compiles(self) -> int:
        """The programs set up over all (method, bucket, X shape)."""
        return sum(self.trace_counts.values())
