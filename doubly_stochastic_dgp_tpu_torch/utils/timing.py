"""Per-call timing of a device computation.

Counterpart of ``doubly_stochastic_dgp_tpu/utils/timing.py``
(``timed_per_call_stats``, ``timed_per_call``) with the same contract:
``call(i)`` runs one unique execution (``i`` may be folded into a seed or
an input), is called once with ``i = -1`` to warm up, then ``repeats``
blocks of ``n`` calls with ``i = 0 .. repeats n - 1``.  The JAX helper
synchronised by a scalar read from the host and subtracted its round
trip; here a block whose warm-up output holds a CUDA tensor is timed with
CUDA events on the current stream (device time from the first launch to
the last), and any other block with the host clock, after a
``torch.cuda.synchronize`` where a card is present.
"""

from __future__ import annotations

import statistics
import time

import torch

__all__ = ["timed_per_call", "timed_per_call_stats"]


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for o in out:
            t = _first_tensor(o)
            if t is not None:
                return t
    return None


def _block_seconds(call, start, n, on_card):
    if on_card:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for i in range(n):
            call(start + i)
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / 1e3
    t0 = time.perf_counter()
    for i in range(n):
        call(start + i)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def timed_per_call_stats(call, n=30, repeats=3):
    """Per-block mean seconds a ``call(i)``, with their spread: a dict of
    the best (min), median and max of the ``repeats`` block means,
    ``spread_pct`` = 100 (max - best) / best, ``repeats`` and ``clock``
    ('cuda events' or 'host')."""
    first = _first_tensor(call(-1))
    on_card = first is not None and first.is_cuda
    if on_card:
        torch.cuda.synchronize(first.device)
    means = [_block_seconds(call, r * n, n, on_card) / n
             for r in range(max(1, repeats))]
    best = min(means)
    return {
        "best": best,
        "median": statistics.median(means),
        "max": max(means),
        "spread_pct": 100.0 * (max(means) - best) / best if best > 0 else 0.0,
        "repeats": len(means),
        "clock": "cuda events" if on_card else "host",
    }


def timed_per_call(call, n=30, repeats=3):
    """Best-of-``repeats`` mean seconds a ``call(i)`` (see
    :func:`timed_per_call_stats`)."""
    return timed_per_call_stats(call, n=n, repeats=repeats)["best"]
