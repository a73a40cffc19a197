"""Process groups, device meshes, the port's collectives and a launcher
of local ranks.

Counterpart of ``doubly_stochastic_dgp_tpu/parallel/mesh.py``.  JAX runs
one program over a ``jax.sharding.Mesh`` of devices; PyTorch runs one
process (a rank) per device, joined by a ``torch.distributed`` process
group.  A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` over
every rank of the group with named dimensions: :func:`make_mesh` builds
the 1-D one; a 2-D (data x sample) mesh is built with
``init_device_mesh(device_type, (n_data, n_sample), mesh_dim_names=
("data", "sample"))`` directly, as the JAX tests build a 2-D ``Mesh``
directly (rank = data index x n_sample + sample index).

Each rank holds the whole replicated model and the global data, as a JAX
caller does, and takes its own rows (:func:`shard_along`), which is what
``in_specs=P(axis)`` did.

The collectives: :func:`all_reduce` (sum or mean, the JAX ``psum`` and
``pmean``) and :func:`all_gather` (tiled along dim 0) are autograd
Functions whose backward all-reduces the incoming gradient over the same
group.  The gradient rule of every objective in ``parallel`` follows from
it: each rank back-propagates its *share*, the replicated objective
divided by the number of ranks whose parameter gradients are then summed
(:func:`all_reduce_sum_`, one flat all-reduce); so a term every rank
computes alike counts once in the sum, and a rank's local rows get their
own gradient.  (``torch.distributed.nn.functional.all_reduce`` has the
same backward; used on the undivided objective it counts a replicated
term n times.)  Row-sharded leaves (a Damianou model's q(H) state) are
left out of the parameter all-reduce.

Under NCCL the gather is ``all_gather_into_tensor`` and its backward a
``reduce_scatter_tensor`` of the incoming gradient (the sum over the
ranks, this rank's block).  Gloo has no CUDA form of ``all_gather`` (the
``torch.distributed`` backend table: on GPU tensors gloo runs only
``broadcast`` and ``all_reduce``), so under gloo the gather is an
all-reduce of a zero-filled buffer that holds this rank's block: exact
(x + 0 = x), at n times the bytes of a gather.

Two more for the output-dimension and pipeline axes
(``parallel/outdim.py``, ``parallel/pp.py``): :func:`all_gather_last`,
the gather along the last axis (JAX's ``all_gather(x, axis, axis=-1,
tiled=True)``), is :func:`all_gather` behind a ``movedim``; and
:func:`shift`, JAX's ``ppermute(x, axis, [(i, i + 1)])``, hands each
position its predecessor's ``x`` (zeros at position 0), and its backward
hands the gradient one position back.  The shift is the gather of every
position's ``x``, of which each rank keeps its predecessor's block: exact,
at n times the bytes of a send (gloo has no CUDA ``send`` or ``recv``; a
send/receive form for NCCL across cards has not been written).  Every
rank issues the same collectives, rank 0 and the last rank included, so
that every rank's forward and backward pair up.

Random numbers: JAX folds the device index into the key; here a rank
draws from :func:`rank_generator` (seed, index): index 0 takes ``seed``
itself, so a one-rank mesh reproduces the single-process stream.

``initialize_distributed`` takes the backend from the device: NCCL on the
card, gloo only where the caller asks for the CPU or names it (several
ranks sharing one card must use gloo: NCCL refuses two ranks on one
GPU).  It never falls back from NCCL to gloo.
"""

from __future__ import annotations

import datetime
import shutil
import tempfile
import traceback
from typing import Optional

import torch
import torch.distributed as dist

from ..config import resolve_device
from ..serving import derive_seed

__all__ = ["make_mesh", "replicate", "shard_along", "shard_chains",
           "pad_to_multiple", "initialize_distributed", "axis_size",
           "axis_index", "all_reduce", "all_reduce_many", "all_gather",
           "all_gather_last", "shift", "all_reduce_sum_", "rank_generator",
           "capturable", "run_ranks"]

DEFAULT_TIMEOUT_S = 300.0


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, backend: Optional[str] = None,
                           device=None, timeout_s: float = DEFAULT_TIMEOUT_S):
    """``init_process_group`` for rank ``process_id`` of ``num_processes``
    at ``coordinator_address`` ('host:port', or a URL such as
    'tcp://host:port' or 'file:///path').  No-op
    (returns False) without an address, as the JAX function is.

    ``backend``: default 'nccl' on the card and 'gloo' when ``device`` is
    'cpu'; 'gloo' may be named for CUDA tensors too.  'nccl' without NCCL
    or without a card raises: nothing falls back to gloo.  With NCCL the
    rank's card is ``device`` (default cuda:process_id mod the cards)."""
    if coordinator_address is None:
        return False
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        if dev.type != "cuda" or not dist.is_nccl_available():
            raise RuntimeError(
                f"backend 'nccl' needs a CUDA device and a torch built with "
                f"NCCL (device {dev}, NCCL available "
                f"{dist.is_nccl_available()}); pass backend='gloo' to run "
                f"the collectives through gloo")
        index = dev.index if dev.index is not None else (
            process_id % torch.cuda.device_count())
        torch.cuda.set_device(index)
    elif backend != "gloo":
        raise ValueError(f"backend must be 'nccl' or 'gloo'; got {backend!r}")
    address = coordinator_address
    if "://" not in address:
        address = f"tcp://{address}"
    dist.init_process_group(
        backend, init_method=address, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    return True


def make_mesh(num_devices: Optional[int] = None, axis: str = "data"):
    """A 1-D mesh named ``axis`` over every rank of the process group
    (``num_devices``, if given, must be its size: the port's meshes span
    the whole group).  The mesh's device type is 'cuda' under NCCL, else
    'cpu' (gloo; the tensors may still be on the card)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_distributed "
                           "(or torch.distributed.init_process_group) first")
    world = dist.get_world_size()
    if num_devices is not None and num_devices != world:
        raise ValueError(f"num_devices={num_devices}: the mesh spans every "
                         f"rank of the process group ({world}); start "
                         f"{num_devices} ranks")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, (world,), mesh_dim_names=(axis,))


def _dim(mesh, axis):
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r} (axes {names})")
    return names.index(axis)


def axis_size(mesh, axis: str) -> int:
    """The number of ranks along ``axis`` (the JAX ``mesh.shape[axis]``)."""
    return mesh.size(_dim(mesh, axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's position along ``axis`` (``jax.lax.axis_index``)."""
    return mesh.get_local_rank(_dim(mesh, axis))


def _group(mesh, axis):
    return mesh.get_group(_dim(mesh, axis))


def _world(mesh):
    """The group of the whole mesh: the default group, which the port's
    meshes span."""
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"the mesh covers {mesh.size()} of "
                         f"{dist.get_world_size()} ranks")
    return None


def capturable(mesh) -> bool:
    """Whether a CUDA graph can hold the mesh's collectives: NCCL's can be
    captured, gloo's cannot (a gloo collective runs on the host)."""
    return dist.get_backend(mesh.get_group(0)) == "nccl"


def rank_generator(seed: int, index: int, device) -> torch.Generator:
    """The generator of position ``index`` on a mesh axis for ``seed``:
    seeded with ``seed`` at index 0 (a one-rank mesh draws the
    single-process stream), else with ``derive_seed(seed, index)``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) if index == 0 else derive_seed(seed, index))
    return g


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group; the backward sums the incoming gradient over the
    same group (module docstring: the gradient rule)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce(x, mesh, axis: str, op: str = "sum"):
    """``x`` summed (``op='sum'``, the JAX ``psum``) or averaged
    (``'mean'``, ``pmean``) over ``axis``, differentiable; or its
    maximum (``'max'``, ``pmax``), not differentiated."""
    if op == "max":
        y = x.detach().contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=_group(mesh, axis))
        return y
    y = _AllReduceSum.apply(x, _group(mesh, axis))
    if op == "sum":
        return y
    if op == "mean":
        return y / axis_size(mesh, axis)
    raise ValueError(f"op must be 'sum', 'mean' or 'max'; got {op!r}")


def _split(flat, like):
    """``flat`` cut into views shaped as the tensors ``like``."""
    parts, start = [], 0
    for t in like:
        parts.append(flat[start:start + t.numel()].view(t.shape))
        start += t.numel()
    return parts


def all_reduce_many(tensors, mesh, axis: str):
    """Each of ``tensors`` summed over ``axis`` by one all-reduce of their
    concatenation; differentiable."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    return _split(all_reduce(flat, mesh, axis), tensors)


class _AllGather(torch.autograd.Function):
    """The NCCL gather; the backward sums the incoming gradient over the
    group and keeps this rank's block (module docstring: the gradient
    rule)."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group = group
        x = x.contiguous()
        y = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(y, x, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        n = dist.get_world_size(ctx.group)
        out = g.new_empty((g.shape[0] // n,) + tuple(g.shape[1:]))
        dist.reduce_scatter_tensor(out, g, group=ctx.group)
        return out, None, None


def all_gather(x, mesh, axis: str):
    """The ranks' ``x`` concatenated along dim 0 in axis order (the tiled
    ``jax.lax.all_gather``); differentiable, each rank's block getting the
    sum over the ranks of its rows' gradient.  Under NCCL a gather, under
    gloo an all-reduce of a zero-filled buffer holding this rank's block
    (gloo has no CUDA all_gather)."""
    n, r = axis_size(mesh, axis), axis_index(mesh, axis)
    group = _group(mesh, axis)
    if dist.get_backend(group) == "nccl":
        return _AllGather.apply(x, group, n)
    zero = torch.zeros_like(x)
    return all_reduce(torch.cat([x if i == r else zero for i in range(n)]),
                      mesh, axis)


def all_gather_last(x, mesh, axis: str):
    """The ranks' ``x`` concatenated along the last dim in axis order (the
    tiled ``jax.lax.all_gather`` along the last axis): :func:`all_gather`
    of ``x`` with its last dim moved in front; differentiable."""
    return all_gather(x.movedim(-1, 0), mesh, axis).movedim(0, -1)


def shift(x, mesh, axis: str):
    """The ``x`` of the previous position on ``axis`` (zeros at position
    0): JAX's ``ppermute(x, axis, [(i, i + 1) for i in range(n - 1)])``;
    differentiable, the gradient handed one position back.  The gather of
    every position's ``x``, of which each rank keeps its predecessor's
    block."""
    r = axis_index(mesh, axis)
    blocks = all_gather(x[None], mesh, axis)              # (n, *x.shape)
    # block r - 1, or zeros at position 0: an index into the padded
    # blocks, so that rank 0's backward runs the gather's collective too
    return torch.cat([torch.zeros_like(blocks[:1]), blocks[:-1]])[r]


@torch.no_grad()
def all_reduce_sum_(tensors, mesh, axis: Optional[str] = None):
    """Sum each of ``tensors`` over ``axis`` (default: the whole mesh) in
    place, by one all-reduce of their concatenation (one collective, one
    launch under NCCL)."""
    if not tensors:
        return tensors
    group = _world(mesh) if axis is None else _group(mesh, axis)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    torch._foreach_copy_(tensors, _split(flat, tensors))
    return tensors


@torch.no_grad()
def replicate(module, mesh):
    """Broadcast every parameter and buffer of ``module`` from rank 0, in
    place, so every rank holds rank 0's values; returns the module."""
    _world(mesh)
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0)
    return module


def _slice(x, n, r, dim, what):
    size = x.shape[dim]
    if size % n != 0:
        raise ValueError(f"{what}: size {size} along dim {dim} does not "
                         f"divide over {n} ranks")
    k = size // n
    return x.narrow(dim, r * k, k)


def shard_along(x, mesh, axis: str = "data", dim: int = 0):
    """This rank's contiguous block of ``x`` along ``dim``, split over the
    mesh axis ``axis`` (the size must divide)."""
    return _slice(x, axis_size(mesh, axis), axis_index(mesh, axis), dim,
                  f"shard_along('{axis}')")


def shard_chains(mesh, chain_axis: Optional[str], num_chains: int,
                 *arrays):
    """Each array's block of chains (leading dim) for this rank: MCMC
    chains are independent, so the chain axis splits with no per-step
    collectives.  ``num_chains`` must divide by the axis size
    (``chain_axis`` default: the mesh's first axis)."""
    ax = chain_axis or mesh.mesh_dim_names[0]
    n = axis_size(mesh, ax)
    if num_chains % n != 0:
        raise ValueError(
            f"num_chains={num_chains} must divide by mesh axis "
            f"'{ax}' size {n}")
    r = axis_index(mesh, ax)
    return tuple(_slice(a, n, r, 0, "shard_chains") for a in arrays)


def pad_to_multiple(X, m: int, axis: int = 0):
    """Pad X along ``axis`` (repeating the last row) so its size is a
    multiple of m.  Returns (padded, original size)."""
    n = X.shape[axis]
    rem = (-n) % m
    if rem == 0:
        return X, n
    last = X.narrow(axis, n - 1, 1)
    reps = [1] * X.ndim
    reps[axis] = rem
    return torch.cat([X, last.repeat(*reps)], dim=axis), n


# -- a launcher of local ranks ------------------------------------------------

def _rank_main(rank, world, address, backend, device, threads, timeout_s,
               fn, args, queue):
    try:
        if threads:
            torch.set_num_threads(threads)
        initialize_distributed(address, world, rank, backend=backend,
                               device=device, timeout_s=timeout_s)
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        queue.put((rank, True, out))
    except BaseException:                              # noqa: BLE001
        queue.put((rank, False, traceback.format_exc()))


def run_ranks(fn, nprocs: int, args=(), backend: str = "gloo",
              device="cuda", timeout_s: float = 600.0, threads=None):
    """Run ``fn(rank, *args)`` on ``nprocs`` local ranks, each a fresh
    process (the 'spawn' start method: it imports ``fn``'s module, and
    nothing of the caller's) in a process group of ``backend`` on
    ``device``, joined through a file store in a temporary directory;
    returns the ranks' return values (picklable) in rank order.  The ranks
    run on the card unless ``device="cpu"`` asks for the CPU (gloo takes
    CUDA tensors, so its ranks may share one card).

    Every collective and the whole run are bounded by ``timeout_s``: a
    rank that raises or a run that does not end in time terminates every
    rank and raises ``RuntimeError`` naming the rank and its traceback."""
    import multiprocessing as mp
    import queue as queue_mod
    import time

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    # a file store in a fresh directory: no port to pick, none to collide
    store = tempfile.mkdtemp(prefix="run_ranks_")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, nprocs, f"file://{store}/store", backend,
                               device, threads, timeout_s, fn, tuple(args),
                               results),
                         daemon=True)
             for r in range(nprocs)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + timeout_s
    try:
        while len(out) < nprocs:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(
                    f"run_ranks: {nprocs - len(out)} of {nprocs} ranks did "
                    f"not finish within {timeout_s} s (ranks done: "
                    f"{sorted(out)})")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    raise RuntimeError(
                        f"run_ranks: rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} without a result")
                continue
            if not ok:
                raise RuntimeError(f"run_ranks: rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
        shutil.rmtree(store, ignore_errors=True)
    return [out[r] for r in range(nprocs)]

