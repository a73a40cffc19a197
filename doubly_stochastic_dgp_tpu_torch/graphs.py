"""One captured CUDA graph per dispatch: the counterpart of the JAX
package's jitted programs (the ``lax.scan`` training chunk, the jitted
``make_server`` request).

On a CUDA tensor the trainer (``training/loop.py``) captures a chunk of
optimizer steps, and the server (``serving.py``) each request shape, with
``torch.cuda.graph`` and replays it: one launch of the whole program from
the host, with no host sync inside it.  The CPU runs the same code
eagerly, and so does the card inside :func:`eager_on_card`, the
reference for measurements, which the package itself never enters.

A graph must not draw random numbers (it would bake in the generator's
state at capture).  The code that draws calls :func:`randn`, :func:`rand`
and :func:`randint`, which take a ``torch.Generator`` or a draw source in
its place, an object with :meth:`DrawTape.draw`'s signature (a
:class:`DrawTape`, or a test's source that replays another package's
draws): the tape notes the draws of an eager warm-up, hands the
capture static buffers in their place, and before each replay draws into
those buffers from the caller's generator in the noted order, which is
the eager order.  A graphed call thus sees the numbers of the eager call
and leaves the generator in the same state.

The kernels' launch counters (``fused_conditional.launches`` and the
rest) tick only where a wrapper launches its kernel: in the eager warm-up
a capture runs, and in the capture, whose launches go into the graph.  A
replay runs no wrapper and ticks no launch counter; ``graph.replays``
counts the replays, and ``graph.captures`` and ``graph.capture_s`` the
captures and their seconds (``tracing.counters()`` reads them all in one
snapshot).  A profiler (``torch.profiler``) sees the kernels a replay
runs.
"""

from __future__ import annotations

import contextlib
import gc
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from . import tracing


__all__ = ["eager_on_card", "graphs_enabled", "DrawTape", "randn", "rand",
           "randint", "CapturedCall", "no_host_reads"]

_eager = False


@contextlib.contextmanager
def eager_on_card():
    """Training chunks and requests on CUDA tensors run eagerly while
    inside (no capture, no replay)."""
    global _eager
    _eager = True
    try:
        yield
    finally:
        _eager = False


def graphs_enabled(device) -> bool:
    """Whether a dispatch on ``device`` runs as a captured graph."""
    return torch.device(device).type == "cuda" and not _eager


class DrawTape:
    """The random draws of one captured call, made outside the graph.

    Until :meth:`freeze` the tape draws from ``generator`` and notes each
    draw (the eager warm-up); after it, each draw hands out the next of
    the tape's static buffers (the capture), and :meth:`fill` draws into
    the buffers from a generator, in the noted order."""

    def __init__(self, generator):
        self.generator = generator
        self.plan = []
        self.buffers = None
        self._next = 0

    def draw(self, kind, shape, dtype, device, high=None):
        entry = (kind, tuple(shape), dtype, torch.device(device), high)
        if self.buffers is None:
            self.plan.append(entry)
            return _draw(entry, self.generator)
        if self._next >= len(self.plan) or self.plan[self._next] != entry:
            raise RuntimeError(
                f"DrawTape: draw {self._next} is {entry}, but the warm-up "
                f"drew {self.plan[self._next:self._next + 1]}")
        self._next += 1
        return self.buffers[self._next - 1]

    def freeze(self):
        """Allocate the static buffers; later draws hand them out."""
        self.buffers = [torch.empty(shape, dtype=dtype, device=device)
                        for _, shape, dtype, device, _ in self.plan]
        self._next = 0

    def fill(self, generator):
        """Draw the noted draws from ``generator`` into the buffers."""
        for entry, buf in zip(self.plan, self.buffers):
            _draw(entry, generator, out=buf)


def _draw(entry, generator, out=None):
    kind, shape, dtype, device, high = entry
    if kind in ("randn", "rand"):
        f = torch.randn if kind == "randn" else torch.rand
        if out is not None:
            return f(shape, generator=generator, out=out)
        return f(shape, generator=generator, dtype=dtype, device=device)
    if out is not None:
        return torch.randint(0, high, shape, generator=generator, out=out)
    return torch.randint(0, high, shape, generator=generator, dtype=dtype,
                         device=device)


def _is_source(generator):
    return not isinstance(generator, torch.Generator) and hasattr(
        generator, "draw")


def randn(shape, generator, dtype, device):
    """Unit normals from a ``torch.Generator`` or a draw source."""
    if _is_source(generator):
        return generator.draw("randn", shape, dtype, device)
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=device)


def rand(shape, generator, dtype, device):
    """Uniforms on [0, 1) from a ``torch.Generator`` or a draw source."""
    if _is_source(generator):
        return generator.draw("rand", shape, dtype, device)
    return torch.rand(shape, generator=generator, dtype=dtype, device=device)


def randint(high, shape, generator, device):
    """int64 draws uniform on [0, high) from a ``torch.Generator`` or a
    draw source."""
    if _is_source(generator):
        return generator.draw("randint", shape, torch.int64, device, high)
    return torch.randint(0, high, shape, generator=generator, device=device)


class _LastOp(TorchDispatchMode):
    """Notes the last aten op dispatched, to name a failed capture's op."""

    last = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.last = func
        return func(*args, **(kwargs or {}))


_aten = torch.ops.aten
# ops that read a value on the host, or whose output shape depends on the
# values (so the host must read a count before it can allocate)
_HOST_READS = (_aten._local_scalar_dense, _aten.nonzero, _aten.masked_select,
               _aten._unique2, _aten.unique_dim, _aten.unique_consecutive,
               _aten.repeat_interleave)


# indexing ops, which are value-shaped when an index is a bool mask
_INDEXING = (_aten.index, _aten.index_put, _aten.index_put_,
             _aten._index_put_impl_)


class _NoHostReads(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in _HOST_READS or (
                func.overloadpacket in _INDEXING and any(
                    i is not None and i.dtype == torch.bool
                    for i in args[1])):
            raise RuntimeError(f"host read: {func}")
        return func(*args, **(kwargs or {}))


def no_host_reads():
    """A context in which an op that reads a tensor's value on the host
    (``aten._local_scalar_dense``: ``.item()``, ``bool()``, ``float()``)
    or has a value-shaped output (``nonzero``, ``masked_select``,
    ``unique``, ``repeat_interleave``) raises: on the CPU, the proof that
    code a graph captures on the card needs no host sync."""
    return _NoHostReads()


class CapturedCall:
    """``body()`` captured once as a CUDA graph.

    ``warmup()`` runs first on a side stream, eagerly: it must run the
    body's code once (lazy initialization, library handles and
    workspaces, the tape's draws) and leave every persistent tensor as it
    found it.  The graph's memory comes from ``pool`` (a
    ``torch.cuda.graph_pool_handle()`` that other captures share) or, by
    default, from a private pool.  A capture that fails raises, naming
    the last op it dispatched; nothing falls back to eager.
    :meth:`replay` returns the body's outputs, which the next replay
    overwrites (and, in a shared pool, so may another graph's replay).
    :meth:`pool_bytes` is the size of the graph's memory pool."""

    def __init__(self, body, warmup, what, pool=None):
        t = time.perf_counter()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            warmup()
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        last = _LastOp()
        # no cyclic garbage collection inside the capture (torch.cuda.graph
        # collects on entry): a collection there, in this thread or in
        # autograd's, could free CUDA objects (another graph and its pool)
        # mid-capture; other threads' CUDA calls (autograd's, the
        # profiler's) are not this capture's to refuse
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, pool=pool,
                                  capture_error_mode="thread_local"), last:
                self.outputs = body()
        except Exception as e:
            raise RuntimeError(f"{what}: CUDA graph capture failed at "
                               f"{last.last}: {e}") from e
        finally:
            gc.enable()
        tracing.count("graph.captures")
        tracing.count("graph.capture_s", time.perf_counter() - t)

    def pool_bytes(self):
        pool = tuple(self.graph.pool())
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)

    def replay(self):
        tracing.count("graph.replays")
        self.graph.replay()
        return self.outputs
