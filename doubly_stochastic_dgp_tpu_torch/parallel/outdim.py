"""Output-dimension (tensor-parallel) sharding of a DGP over a mesh axis.

Counterpart of ``doubly_stochastic_dgp_tpu/parallel/outdim.py``.  Each
layer's D_out-batched variational parameters (q_mu columns, q_sqrt's
leading axis) and the columns of a Linear or Constant mean function
split over a mesh axis; kernels, inducing inputs and the minibatch stay
replicated.  Each rank computes the conditional and the reparameterized
sample of its own slice of latent dimensions (the (D, M, M)-batched
algebra a single process runs for all of them), and one gather along the
last axis a layer (:func:`~.mesh.all_gather_last`) rebuilds the (S, N,
D_l) input of the next layer.  Likelihoods that factorize over the
output dims (every elementwise one) score each rank's own dims of the
targets, and the bound is one all-reduce; ``MultiClass``, whose
robust-max couples the K latent dims (the MNIST DGP's 30 and 10 latent
GPs), gathers the final layer's (S, N, K) moments once more and scores
the replicated targets on every rank.

Input-propagation stacks work too: the propagated raw input columns are
replicated, so each layer's hidden D_out splits and the gathered samples
get the raw columns put back in front before the next layer.

Restrictions (asserted, with the JAX messages): SVGP layers with
Zero, Identity, Linear or Constant mean functions, and every layer's
D_out (and D_Y, when the likelihood factorizes) divisible by the axis
size.

One JAX program over the mesh is one process a rank here
(``parallel/mesh.py``).  A model on every rank may be whole (each rank
takes its columns of the sharded leaves inside the objective) or placed
by :func:`outdim_shard` (its sharded leaves hold the rank's columns
only).  The rank's layers are views (``utils.params.module_view``): each
describes the rank's columns (``num_outputs``, q_mu, q_sqrt, the mean
function) and leaves the model as it was.  Gradients follow the rule of
``parallel/mesh.py``: each rank back-propagates the replicated bound over
the ranks, one all-reduce sums the replicated leaves' gradients, and a
placed model's sharded leaves keep their own (summed over the data and
sample axes of a 2-D or 3-D mesh), with Adam state of their own.

Random numbers (``zs`` None): the rank at position i of the mesh's
(data, sample, dim) axes (those the function uses, flattened in that
order) draws every layer's (S_local, rows, d_local) normals in turn from
``rank_generator(seed, i)``; a one-rank mesh draws the single-process
stream.  ``zs`` (one (S, 1 or N, D_l) array a layer) pins the draws: a
rank takes its columns (and on a sample axis its samples), and the value
is the single-process bound on the same draws.

The steps run eagerly, one dispatch a step, as ``make_dp_train_step``:
under gloo nothing can be captured, and a graph of the NCCL step is not
built here.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
from torch import nn

from ..graphs import randn
from ..models.mean_functions import Identity, Zero
from ..ops.linalg import reparameterize
from ..utils.params import module_view, owner_of
from .dp import make_sharded_train_step
from .mesh import (all_gather_last, all_reduce, axis_index, axis_size,
                   rank_generator, replicate, shard_along)

__all__ = ["outdim_specs", "outdim_shard", "outdim_elbo",
           "make_outdim_train_step", "elbo_2d", "make_2d_train_step",
           "elbo_3d", "make_3d_train_step"]


class ShardedIdentity(nn.Module):
    """Identity mean under output-dim sharding: the rank's slice of the
    input dims, columns [start, start + width)."""

    def __init__(self, width: int, start: int):
        super().__init__()
        self.width, self.start = int(width), int(start)

    def forward(self, X):
        return X[..., self.start:self.start + self.width]


def _factorizes(likelihood) -> bool:
    return bool(getattr(likelihood, "factorizes_over_dims", True))


def _spec(name, ndim, axis, fact):
    """The PartitionSpec of one leaf, as a tuple (JAX ``spec_for``)."""
    parts = name.split(".")
    if "layers" in parts:
        if "q_mu" in parts:
            return (None, axis)
        if "q_sqrt" in parts:
            return (axis, None, None)
        if "mean_function" in parts:
            if "W" in parts:
                return (None, axis)
            if "b" in parts or "c" in parts:
                return (axis,)
    if "Y_data" in parts and fact:
        return (None, axis)
    return (None,) * ndim


def _layer_dim(name, ndim, axis):
    """The dim a layer leaf (``name`` inside a layer) splits along over
    ``axis``, or None."""
    spec = _spec("layers." + name, ndim, axis, False)
    return spec.index(axis) if axis in spec else None


def outdim_specs(model, axis: str = "dim"):
    """{parameter or buffer name: its PartitionSpec as a tuple}, the JAX
    PartitionSpec tree's counterpart: q_mu, q_sqrt and Linear/Constant
    mean leaves split over ``axis`` on their D_out dimension, Y_data on
    its columns (replicated for non-factorizing likelihoods, whose
    targets every rank scores), everything else replicated."""
    fact = _factorizes(model.likelihood)
    named = list(model.named_parameters()) + list(model.named_buffers())
    return {name: _spec(name, t.ndim, axis, fact) for name, t in named}


def _check_divides(layer, n):
    D = layer.num_outputs_
    if D % n != 0:
        raise AssertionError(
            f"layer D_out={D} not divisible by mesh axis size {n}")
    return D // n


def outdim_shard(model, mesh, axis: str = "dim"):
    """A copy of ``model`` placed on the mesh: each layer's q_mu, q_sqrt
    and Linear/Constant mean leaves hold this rank's block of the latent
    dims (their memory divides by the axis size), everything else is
    rank 0's, broadcast.  The data buffers stay whole: every function
    takes its rows and columns of the data it is given."""
    n = axis_size(mesh, axis)
    for layer in model.layers:
        _check_divides(layer, n)
    placed = copy.deepcopy(model)
    replicate(placed, mesh)
    with torch.no_grad():
        for name, p in list(placed.named_parameters()):
            if not name.startswith("layers."):
                continue
            dim = _layer_dim(name.split(".", 2)[2], p.ndim, axis)
            if dim is not None:
                owner, attr = owner_of(placed, name)
                setattr(owner, attr, nn.Parameter(
                    shard_along(p.detach(), mesh, axis, dim).clone(),
                    requires_grad=p.requires_grad))
    placed.dim_shard = (axis, n)
    return placed


def _placed(model, axis, n):
    placed = getattr(model, "dim_shard", None)
    if placed is not None and placed != (axis, n):
        raise ValueError(f"the model is placed on {placed}, not on "
                         f"('{axis}', {n})")
    return placed is not None


def _localize(model, mesh, axis):
    """The rank's view of each layer (JAX ``_localize``): its
    ``num_outputs``, q_mu, q_sqrt and mean function describe the rank's
    dims (Zero and Identity means rebuilt for them; a whole model's
    sharded leaves cut to the rank's columns)."""
    n, k = axis_size(mesh, axis), axis_index(mesh, axis)
    placed = _placed(model, axis, n)
    views = []
    for layer in model.layers:
        d = _check_divides(layer, n)

        def leaf(name, t, d=d):
            dim = None if placed else _layer_dim(name, t.ndim, axis)
            return t if dim is None else t.narrow(dim, k * d, d)

        view = module_view(layer, leaf)
        view.num_outputs_ = d
        mf = layer.mean_function
        if isinstance(mf, Zero):
            view.mean_function = Zero(d)
        elif isinstance(mf, Identity):
            view.mean_function = ShardedIdentity(d, k * d)
        # Linear / Constant: their leaves are cut by ``leaf`` already
        views.append(view)
    return views


def _dim_params(model, axis):
    """A placed model's sharded parameters (its rank's own), else []."""
    if getattr(model, "dim_shard", None) is None:
        return []
    return [p for name, p in model.named_parameters()
            if name.startswith("layers.")
            and _layer_dim(name.split(".", 2)[2], p.ndim, axis) is not None]


def _generator(seed, zs, model, mesh, axes):
    """``rank_generator(seed, i)``, i the rank's position on ``axes``
    flattened in order; None with fixed draws."""
    if zs is not None:
        return None
    index = 0
    for ax in axes:
        index = index * axis_size(mesh, ax) + axis_index(mesh, ax)
    return rank_generator(0 if seed is None else seed, index,
                          model.X_data.device)


def _local_zs(zs, like, mesh, dim_axis, sample_axis=None):
    """The rank's columns (and samples, on ``sample_axis``) of each
    layer's fixed draws."""
    if zs is None:
        return None
    out = []
    for z in zs:
        z = torch.as_tensor(z, dtype=like.dtype, device=like.device)
        if sample_axis is not None:
            z = shard_along(z, mesh, sample_axis, dim=0)
        out.append(shard_along(z, mesh, dim_axis, dim=z.ndim - 1))
    return out


def _gather_next_input(F, F_local, layer, mesh, axis):
    """The locally sampled dims gathered into the next layer's input;
    a layer with ``input_prop_dim`` p puts the propagated raw input
    columns (F's first p, replicated) back in front, as
    ``Layer.sample_from_conditional`` concatenates them."""
    nxt = all_gather_last(F_local, mesh, axis)
    p = layer.input_prop_dim
    if p:
        nxt = torch.cat([F[:, :, :p], nxt], dim=2)
    return nxt


def _propagate(views, X, S, zs_l, generator, mesh, axis):
    """The final layer's local moments (S, N, d_local) after sampling
    through the views, one gather a layer."""
    F = X[None].expand(S, *X.shape)
    mean = var = None
    for li, layer in enumerate(views):
        mean, var = layer.conditional_SND(F)            # local dims
        z = (zs_l[li].expand(mean.shape) if zs_l is not None
             else randn(mean.shape, generator, mean.dtype, mean.device))
        F_local = reparameterize(mean, var, z, layer.jitter)
        if li < len(views) - 1:
            # the next layer consumes every dim
            F = _gather_next_input(F, F_local, layer, mesh, axis)
    return mean, var


def _kl_local(views, like):
    return sum((layer.KL() for layer in views),
               torch.zeros((), dtype=like.dtype, device=like.device))


def _scored(model, mean, var, Y_l, fact, mesh, axis):
    """The rank's summed variational expectations: its own dims when the
    likelihood factorizes; else the final moments gathered over ``axis``
    and the full-dim expectation, the same on every rank of it."""
    if not fact:
        mean = all_gather_last(mean, mesh, axis)
        var = all_gather_last(var, mesh, axis)
    ve = model.likelihood.variational_expectations(mean, var, Y_l)
    return torch.sum(torch.mean(ve, dim=0))


def outdim_elbo(model, X, Y, seed, mesh, axis: str = "dim",
                batch_size: Optional[int] = None, zs=None):
    """The ELBO of the batch (X, Y) with every layer's latent dims split
    over ``axis``: the single-process ELBO on the same draws.  ``model``
    is whole or placed by :func:`outdim_shard`; ``seed`` takes the JAX
    key's place (module docstring: random numbers); ``zs`` (one (S, 1 or
    N, D_l) array a layer) pins the draws."""
    fact = _factorizes(model.likelihood)
    views = _localize(model, mesh, axis)
    X, Y = model._as_input(X), model._as_input(Y)
    B = batch_size or X.shape[0]
    Y_l = shard_along(Y, mesh, axis, dim=1) if fact else Y
    mean, var = _propagate(views, X, model.num_samples,
                           _local_zs(zs, X, mesh, axis),
                           _generator(seed, zs, model, mesh, (axis,)),
                           mesh, axis)
    KL_local = _kl_local(views, mean)
    scale = model.num_data / B
    like = _scored(model, mean, var, Y_l, fact, mesh, axis)
    if fact:
        # the likelihood term and the KL are both sums over dims: one
        # all-reduce of the local bound
        return all_reduce(like * scale - KL_local, mesh, axis)
    # the gathered expectation is the same on every rank: the mean marks
    # the replication
    like = all_reduce(like, mesh, axis, op="mean")
    return like * scale - all_reduce(KL_local, mesh, axis)


def elbo_2d(model, X, Y, seed, mesh, data_axis: str = "data",
            dim_axis: str = "dim", batch_size: Optional[int] = None,
            zs=None):
    """The ELBO over a 2-D mesh: the minibatch rows split over
    ``data_axis`` (data parallelism, the likelihood summed over it) and
    every layer's latent dims over ``dim_axis`` (a gather a layer); the
    KL is summed over the dim axis and counted once across data
    replicas.  The batch must divide the data axis."""
    fact = _factorizes(model.likelihood)
    views = _localize(model, mesh, dim_axis)
    X, Y = model._as_input(X), model._as_input(Y)
    B = batch_size or X.shape[0]
    X_l = shard_along(X, mesh, data_axis)
    Y_l = shard_along(Y, mesh, data_axis)
    if fact:
        Y_l = shard_along(Y_l, mesh, dim_axis, dim=1)
    mean, var = _propagate(views, X_l, model.num_samples,
                           _local_zs(zs, X_l, mesh, dim_axis),
                           _generator(seed, zs, model, mesh,
                                      (data_axis, dim_axis)),
                           mesh, dim_axis)
    like = _scored(model, mean, var, Y_l, fact, mesh, dim_axis)
    # the likelihood: partial over rows and dims (or, gathered, the same
    # on every rank of the dim axis)
    like = all_reduce(all_reduce(like, mesh, dim_axis,
                                 op="sum" if fact else "mean"),
                      mesh, data_axis)
    # the KL: partial over dims only, replicated across data replicas
    KL = all_reduce(_kl_local(views, like), mesh, dim_axis)
    return like * (model.num_data / B) - KL


def elbo_3d(model, X, Y, seed, mesh, data_axis: str = "data",
            sample_axis: str = "sample", dim_axis: str = "dim",
            batch_size: Optional[int] = None, zs=None):
    """The ELBO over the 3-D (data x sample x dim) mesh, every axis this
    model family has: rows over ``data_axis``, the S Monte-Carlo samples
    over ``sample_axis`` (each rank propagates S / n of them) and every
    layer's latent dims over ``dim_axis``.  The likelihood is averaged
    over the sample groups and summed over rows and dims; the KL is
    summed over dims and counted once across data and sample replicas.
    With ``zs`` (each (S, 1, D_l), split over samples and dims) the value
    is the single-process bound."""
    fact = _factorizes(model.likelihood)
    n_samp = axis_size(mesh, sample_axis)
    if zs is None and model.num_samples % n_samp != 0:
        raise AssertionError(
            f"num_samples={model.num_samples} must divide the "
            f"'{sample_axis}' axis ({n_samp})")
    views = _localize(model, mesh, dim_axis)
    X, Y = model._as_input(X), model._as_input(Y)
    B = batch_size or X.shape[0]
    X_l = shard_along(X, mesh, data_axis)
    Y_l = shard_along(Y, mesh, data_axis)
    if fact:
        Y_l = shard_along(Y_l, mesh, dim_axis, dim=1)
    zs_l = _local_zs(zs, X_l, mesh, dim_axis, sample_axis)
    S_l = zs_l[0].shape[0] if zs_l is not None else (
        model.num_samples // n_samp)
    mean, var = _propagate(views, X_l, S_l, zs_l,
                           _generator(seed, zs, model, mesh,
                                      (data_axis, sample_axis, dim_axis)),
                           mesh, dim_axis)
    like = _scored(model, mean, var, Y_l, fact, mesh, dim_axis)
    # one axis a collective: average the equal sample groups, then sum
    # rows and dims (the mean over dims where the gathered expectation is
    # the same on each)
    like = all_reduce(like, mesh, sample_axis, op="mean")
    like = all_reduce(like, mesh, data_axis)
    like = all_reduce(like, mesh, dim_axis, op="sum" if fact else "mean")
    KL = all_reduce(_kl_local(views, like), mesh, dim_axis)
    return like * (model.num_data / B) - KL


def _train_step(objective, optimizer, mesh, dim_axis, rest_axes):
    """:func:`~.dp.make_sharded_train_step` of ``objective`` with a placed
    model's column-sharded leaves as the rank's own."""
    return make_sharded_train_step(
        objective, lambda model: _dim_params(model, dim_axis), optimizer,
        mesh, dim_axis, rest_axes)


def make_outdim_train_step(optimizer, mesh, axis: str = "dim",
                           batch_size: Optional[int] = None):
    """Step ``step(model, X, Y, seed=None, zs=None) -> loss``: one Adam
    update on -(log prior + :func:`outdim_elbo`) of the batch (X, Y).
    Build ``optimizer`` over the model the step trains: on a placed model
    each rank updates its own columns and keeps Adam state for them
    only; the replicated leaves take the same update on every rank."""
    return _train_step(
        lambda m, X, Y, seed, zs: outdim_elbo(m, X, Y, seed, mesh, axis,
                                              batch_size, zs),
        optimizer, mesh, axis, ())


def make_2d_train_step(optimizer, mesh, data_axis: str = "data",
                       dim_axis: str = "dim",
                       batch_size: Optional[int] = None):
    """:func:`make_outdim_train_step` over the (data x dim) mesh, on
    -(log prior + :func:`elbo_2d`)."""
    return _train_step(
        lambda m, X, Y, seed, zs: elbo_2d(m, X, Y, seed, mesh, data_axis,
                                          dim_axis, batch_size, zs),
        optimizer, mesh, dim_axis, (data_axis,))


def make_3d_train_step(optimizer, mesh, data_axis: str = "data",
                       sample_axis: str = "sample", dim_axis: str = "dim",
                       batch_size: Optional[int] = None):
    """:func:`make_outdim_train_step` over the (data x sample x dim)
    mesh, on -(log prior + :func:`elbo_3d`)."""
    return _train_step(
        lambda m, X, Y, seed, zs: elbo_3d(m, X, Y, seed, mesh, data_axis,
                                          sample_axis, dim_axis, batch_size,
                                          zs),
        optimizer, mesh, dim_axis, (data_axis, sample_axis))
