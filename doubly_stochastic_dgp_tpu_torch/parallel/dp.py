"""Data- and sample-parallel ELBO, training, prediction and evaluation
over a mesh.

Counterpart of ``doubly_stochastic_dgp_tpu/parallel/dp.py``.  The ELBO is
a sum of per-datum expected log-likelihood terms plus a replicated KL,
so the minibatch rows split over a mesh axis: each rank sums its rows'
terms, one all-reduce adds the sums, and the KL counts once.  For
prediction the S samples split instead.

One JAX program over the mesh becomes one process a rank
(``parallel/mesh.py``): every rank holds the replicated model and the
global data and takes its own rows.  The gradient rule (``mesh.py``):
each rank back-propagates its share of the objective, the replicated
value divided by the ranks whose gradients are summed, and one flat
all-reduce sums the parameter gradients.  The scanned step keeps the JAX
form (``grad_inside=True``): a rank's loss is its rows' scaled
likelihood sum minus (KL - log prior) / n, differentiated locally, and
one all-reduce a step sums the loss and every gradient in one buffer.

Random numbers: a rank on the data axis draws from
``rank_generator(seed, index)`` (index 0 takes ``seed``: a one-rank mesh
draws the single-process stream).  On a sample axis every rank draws the
normals of all S samples from the same stream and keeps its block of
them (:class:`SampleShard`), so a sample-split computation sees the
draws of the single-process one.  ``zs`` (one array per layer) pins the
draws, as in the single-process functions: (S, rows or 1, D_l), split by
rows on a data axis and by samples on a sample axis.

On the card a scanned chunk is one captured CUDA graph under NCCL, whose
all-reduce the graph holds; a gloo collective cannot be captured, so
under gloo the chunk runs eagerly (``chunk.dispatch`` records which).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..graphs import rand, randint, randn
from ..training.loop import _Chunk, _chunk_capture, guarded_scan
from ..training.natgrad import natural_leaves, natural_step
from ..training.optim import value_and_grads
from ..utils.params import Param, log_prior
from .mesh import (all_reduce, all_reduce_many, all_reduce_sum_,
                   axis_index, axis_size, capturable, pad_to_multiple,
                   rank_generator, shard_along)

__all__ = ["dp_elbo", "make_dp_train_step", "make_dp_scan_train_step",
           "make_dp_natgrad_adam_step", "dp_predict_y",
           "dp_predict_density", "dp_evaluate_regression",
           "dp_evaluate_classification", "sp_elbo",
           "make_dp_sp_scan_train_step", "dp_value_and_grads",
           "log_prior_sharded", "make_sharded_train_step"]


def _kl_sum(model):
    return sum(layer.KL() for layer in model.layers)


class SampleShard:
    """A draw source for rank ``index`` of ``n`` on a sample axis: a
    normal (or uniform) draw of shape (S_local, ...) draws (n S_local, ...)
    from ``source`` (a ``torch.Generator`` or a draw source) and hands out
    rows [index S_local, (index + 1) S_local); integer draws (minibatch
    indices) pass through, the same on every rank of the axis."""

    def __init__(self, source, n, index):
        self.source, self.n, self.index = source, n, index

    def draw(self, kind, shape, dtype, device, high=None):
        if kind == "randint":
            return randint(high, shape, self.source, device)
        k = shape[0]
        f = randn if kind == "randn" else rand
        full = f((self.n * k,) + tuple(shape[1:]), self.source, dtype, device)
        return full[self.index * k:(self.index + 1) * k]


def dp_value_and_grads(objective, params, mesh, axis: Optional[str] = None,
                       local: Sequence = (), local_axes: Sequence = ()):
    """(value, gradients) of ``objective()`` (a replicated 0-dim tensor)
    in ``params`` under the gradient rule: this rank back-propagates
    value / n (n: the ranks of ``axis``, default the whole mesh), and one
    all-reduce over the same ranks sums the gradients of every parameter
    but the sharded ``local`` ones (a rank's rows, columns or layers),
    which are summed over ``local_axes`` only (the mesh axes they are
    replicated over; none: they keep their own)."""
    n = mesh.size() if axis is None else axis_size(mesh, axis)
    local_ids = {id(p) for p in local}
    with torch.enable_grad():
        value = objective()
        grads = torch.autograd.grad(value / n, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    all_reduce_sum_([g for p, g in zip(params, grads)
                     if id(p) not in local_ids], mesh, axis)
    for ax in local_axes:
        all_reduce_sum_([g for p, g in zip(params, grads)
                         if id(p) in local_ids], mesh, ax)
    return value.detach(), grads


def log_prior_sharded(model, local, mesh, axis: str):
    """``log_prior(model)`` of a placed model whose ``local`` parameters
    hold this rank's share along ``axis`` (columns, layers): the prior
    terms of their Params summed over ``axis``, every other term counted
    once (the JAX ``log_prior`` of the sharded model, one global value)."""
    ids = {id(p) for p in local}
    mine = [m for m in model.modules() if isinstance(m, Param)
            and m.prior is not None and id(m.unconstrained) in ids]
    total = log_prior(model)
    if not mine:
        return total
    part = sum(log_prior(m) for m in mine)
    return total - part + all_reduce(part, mesh, axis)


def make_sharded_train_step(objective, local_params, optimizer, mesh,
                            shard_axis: str, rest_axes: Sequence = ()):
    """Step ``step(model, X, Y, seed=None, zs=None) -> loss``: one Adam
    update of ``optimizer``'s parameters in place on -(log prior +
    ``objective(model, X, Y, seed, zs)``) under the gradient rule, for a
    model whose ``local_params(model)`` (none for a whole model) hold this
    rank's share along ``shard_axis`` (columns, layers): those keep their
    own gradients, summed over ``rest_axes`` only, and their own Adam
    state; every other leaf takes the same update on every rank."""

    @torch.no_grad()
    def step(model, X, Y, seed=None, zs=None):
        local = local_params(model)
        loss, grads = dp_value_and_grads(
            lambda: -(log_prior_sharded(model, local, mesh, shard_axis)
                      + objective(model, X, Y, seed, zs)),
            optimizer.params, mesh, local=local,
            local_axes=rest_axes if local else ())
        torch._foreach_add_(optimizer.params,
                            optimizer.update(grads, optimizer.state))
        return loss

    return step


def _z_rows(z, n_real, n, mesh, axis, like):
    """A layer's draws for this rank's rows: (S, 1, D) broadcast as they
    are; (S, n_real, D) padded like the rows to a multiple of the n ranks
    and split."""
    z = torch.as_tensor(z, dtype=like.dtype, device=like.device)
    if z.shape[-2] == 1:
        return z
    if z.shape[-2] != n_real:
        raise ValueError(f"zs: {z.shape[-2]} rows, the batch has {n_real}")
    z, _ = pad_to_multiple(z, n, axis=z.ndim - 2)
    return shard_along(z, mesh, axis, dim=z.ndim - 2)


def _local_rows(model, X, Y, mesh, axis, zs):
    """This rank's (X, Y, mask, zs) of a global batch: padded (repeating
    the last row) to a multiple of the axis, then split; the mask (None
    without padding) is 1 on real rows."""
    X, Y = model._as_input(X), model._as_input(Y)
    n, n_real = axis_size(mesh, axis), X.shape[0]
    mask = None
    if n_real % n != 0:
        X, _ = pad_to_multiple(X, n)
        Y, _ = pad_to_multiple(Y, n)
        mask = (torch.arange(X.shape[0], device=X.device) < n_real
                ).to(X.dtype)
        mask = shard_along(mask, mesh, axis)
    zs_l = None if zs is None else [_z_rows(z, n_real, n, mesh, axis, X)
                                    for z in zs]
    return (shard_along(X, mesh, axis), shard_along(Y, mesh, axis), mask,
            zs_l, n_real)


def _dp_elbo(model, X, Y, generator, mesh, axis, batch_size, zs):
    X_l, Y_l, mask, zs_l, n_real = _local_rows(model, X, Y, mesh, axis, zs)
    ve = model.E_log_p_Y(X_l, Y_l, generator=generator, zs=zs_l)
    if mask is not None:
        ve = ve * mask[:, None]
    total = all_reduce(torch.sum(ve), mesh, axis)
    B = batch_size or n_real
    # the KL is replicated: added once, outside the all-reduce
    return total * (model.num_data / B) - _kl_sum(model)


def _generator(seed, mesh, axis, model, zs):
    if zs is not None:
        return None
    return rank_generator(0 if seed is None else seed,
                          axis_index(mesh, axis), model.X_data.device)


def dp_elbo(model, X, Y, seed, mesh, axis: str = "data",
            batch_size: Optional[int] = None, zs=None):
    """The ELBO of the batch (X, Y) with its rows split over ``axis``:
    equal to the single-process ELBO on the same draws.  ``batch_size``:
    the global batch for the num_data / batch scale (default: the real
    rows).  A batch that does not divide the axis is padded (repeating
    the last row) and the padded rows masked out of the likelihood sum,
    so the value and its gradients are the unpadded ones.  ``seed``: the
    JAX key's place (a rank draws from ``rank_generator(seed, index)``);
    ``zs`` pins the draws instead."""
    return _dp_elbo(model, X, Y, _generator(seed, mesh, axis, model, zs),
                    mesh, axis, batch_size, zs)


def make_dp_train_step(optimizer, mesh, axis: str = "data",
                       batch_size: Optional[int] = None):
    """Step ``step(model, X, Y, seed=None, zs=None) -> loss``: one Adam
    update of ``optimizer``'s parameters in place on -(log prior +
    ``dp_elbo``) of the global batch (X, Y), with the summed gradients of
    the gradient rule; every rank takes the same update.  For many steps
    a dispatch prefer :func:`make_dp_scan_train_step`."""

    @torch.no_grad()
    def step(model, X, Y, seed=None, zs=None):
        loss, grads = dp_value_and_grads(
            lambda: -(log_prior(model) + dp_elbo(
                model, X, Y, seed, mesh, axis, batch_size, zs)),
            optimizer.params, mesh, axis)
        torch._foreach_add_(optimizer.params,
                            optimizer.update(grads, optimizer.state))
        return loss

    return step


def _chunk(body, optimizer, rejected, what, inner_steps, mesh):
    return _Chunk(body, _chunk_capture(body, optimizer, rejected,
                                       f"{what} chunk of {inner_steps} "
                                       f"steps"),
                  rejected, graphable=capturable(mesh))


def make_dp_scan_train_step(optimizer, mesh, axis: str = "data",
                            batch_size: Optional[int] = None,
                            inner_steps: int = 10,
                            grad_inside: bool = True,
                            reject_nonfinite: bool = False):
    """Chunk ``chunk(model, generator) -> loss``: ``inner_steps``
    data-parallel Adam steps of ``model`` in place, and their mean loss
    (a 0-dim tensor, no host read).  Each rank takes its block of the
    model's stored rows and draws ``batch_size // n`` of them a step with
    replacement from ``generator`` (its ``rank_generator``), then the
    samples; ``batch_size`` is the global minibatch (None: every row).

    The two JAX formulations: ``grad_inside=True``, each rank's loss is
    its rows' scaled likelihood sum minus (KL - log prior) / n, its
    gradients are taken locally and one all-reduce a step sums the loss
    and the gradients; ``grad_inside=False``, the gradient of the
    all-reduced loss under the gradient rule (``dp_value_and_grads``).
    Both take the same draws.  ``reject_nonfinite=True`` (with
    ``grad_inside=True``) runs the single-process guard
    (``training.loop.guarded_scan``) on the summed loss and gradients,
    which every rank holds alike, so every rank accepts and rejects
    alike; ``chunk.rejected`` counts the rollbacks.

    On the card under NCCL the chunk is one captured CUDA graph
    (``training.loop.make_scan_train_step``'s capture, the all-reduces
    inside); under gloo it runs eagerly.  ``chunk.dispatch`` is 'graph'
    or 'eager' after a call."""
    if reject_nonfinite and not grad_inside:
        raise ValueError(
            "reject_nonfinite is implemented for the grad_inside=True "
            "formulation (the default); drop grad_inside=False or the "
            "guard")
    n = axis_size(mesh, axis)
    local_bs = None if batch_size is None else max(1, batch_size // n)
    params = optimizer.params
    rejected_total = torch.zeros_like(optimizer.state.count)

    def minibatch(model, generator):
        X_l = shard_along(model.X_data, mesh, axis)
        Y_l = shard_along(model.Y_data, mesh, axis)
        n_local = X_l.shape[0]
        if local_bs is not None and local_bs < n_local:
            idx = randint(n_local, (local_bs,), generator, X_l.device)
            return X_l[idx], Y_l[idx], local_bs * n
        return X_l, Y_l, n_local * n

    def local_loss(model, X, Y, B, generator):
        ve = model.E_log_p_Y(X, Y, generator=generator)
        # (KL - log prior) / n: the all-reduce counts the replicated terms
        # once
        return -(torch.sum(ve) * (model.num_data / B)
                 - (_kl_sum(model) - log_prior(model)) / n)

    def loss_and_grads(model, generator):
        X, Y, B = minibatch(model, generator)
        loss, grads = value_and_grads(
            lambda: local_loss(model, X, Y, B, generator), params)
        all_reduce_sum_([loss] + grads, mesh, axis)
        return loss, grads

    def loss_only(model, generator):
        X, Y, B = minibatch(model, generator)
        loss = local_loss(model, X, Y, B, generator)
        return all_reduce_sum_([loss], mesh, axis)[0]

    def sharded_loss_and_grads(model, generator):
        X, Y, B = minibatch(model, generator)

        def loss():
            ve = model.E_log_p_Y(X, Y, generator=generator)
            total = all_reduce(torch.sum(ve), mesh, axis)
            return -(total * (model.num_data / B)
                     - (_kl_sum(model) - log_prior(model)))

        return dp_value_and_grads(loss, params, mesh, axis)

    def body(model, generator):
        if reject_nonfinite:
            _, loss, rejected = guarded_scan(
                lambda p, k: loss_and_grads(model, generator),
                lambda p, k: loss_only(model, generator),
                optimizer, params, optimizer.state, range(inner_steps + 1))
            rejected_total.add_(rejected)
            return loss
        step = loss_and_grads if grad_inside else sharded_loss_and_grads
        losses = []
        for _ in range(inner_steps):
            loss, grads = step(model, generator)
            torch._foreach_add_(params,
                                optimizer.update(grads, optimizer.state))
            losses.append(loss)
        return torch.stack(losses).mean()

    kind = "guarded" if reject_nonfinite else "plain"
    return _chunk(torch.no_grad()(body), optimizer, rejected_total,
                  f"data-parallel {kind} training", inner_steps, mesh)


def make_dp_natgrad_adam_step(optimizer, gamma: float, mesh,
                              axis: str = "data",
                              ng_layers: Sequence[int] = (-1,),
                              batch_size: Optional[int] = None):
    """Step ``step(model, X, Y, seed=None, zs=None) -> loss``: the
    alternating loop under data parallelism, both halves on -(log prior
    + ``dp_elbo``) of the global batch (X, Y): a natural-gradient step of
    size ``gamma`` on the (q_mu, q_sqrt) of ``model.layers[i]`` for i in
    ``ng_layers`` from the summed gradient, then an Adam update of
    ``optimizer``'s parameters (built with ``freeze=freeze_q_params(...)``)
    at fresh draws.  The draws come from the rank's generator for
    ``seed``, the natural step's first; ``zs`` = (the natural step's,
    Adam's) pins both.  ``step.rejected`` counts the rejected natural
    updates."""
    rejected = torch.zeros_like(optimizer.state.count)

    @torch.no_grad()
    def step(model, X, Y, seed=None, zs=None):
        generator = _generator(seed, mesh, axis, model, zs)
        z_nat, z_adam = (None, None) if zs is None else zs

        def objective(z):
            return lambda: -(log_prior(model) + _dp_elbo(
                model, X, Y, generator, mesh, axis, batch_size, z))

        _, grads = dp_value_and_grads(objective(z_nat),
                                      natural_leaves(model, ng_layers), mesh,
                                      axis)
        natural_step(model, None, ng_layers, gamma, rejected, grads=grads)
        loss, grads = dp_value_and_grads(objective(z_adam), optimizer.params,
                                         mesh, axis)
        torch._foreach_add_(optimizer.params,
                            optimizer.update(grads, optimizer.state))
        return loss

    step.rejected = rejected
    return step


def _sample_block(z, mesh, axis):
    z = torch.as_tensor(z)
    return z if z.shape[0] == 1 else shard_along(z, mesh, axis)


def _sample_draws(model, seed, mesh, axis, zs):
    """(draw source, zs block) of this rank's samples on ``axis``."""
    if zs is not None:
        return None, [_sample_block(z, mesh, axis) for z in zs]
    g = rank_generator(0 if seed is None else seed, 0, model.X_data.device)
    return SampleShard(g, axis_size(mesh, axis), axis_index(mesh, axis)), None


@torch.no_grad()
def dp_predict_y(model, Xnew, S: int, seed, mesh, axis: str = "data",
                 zs=None):
    """Predictive y mean and variance, (N, D) each, of the S-sample
    mixture, with the samples split over ``axis``: each rank propagates
    its S / n samples, and the per-sample moments pool by one all-reduce
    (mean, and second moment less the squared mean).  The rank's samples
    are its block of the S draws from ``seed`` (or of ``zs``)."""
    n = axis_size(mesh, axis)
    assert S % n == 0, f"S={S} must divide over {n} devices"
    source, zs_l = _sample_draws(model, seed, mesh, axis, zs)
    Fmean, Fvar = model._predict(Xnew, source, S // n, zs_l)
    m, v = model.sample_predict_y(Fmean, Fvar)
    mean, second = all_reduce_many(
        [torch.mean(m, dim=0), torch.mean(v + m ** 2, dim=0)], mesh, axis)
    mean, second = mean / n, second / n
    return mean, second - mean ** 2


@torch.no_grad()
def dp_predict_density(model, Xnew, Ynew, S: int, seed, mesh,
                       axis: str = "data", zs=None):
    """The S-sample mixture's log predictive density, (N, D), with the
    samples split over ``axis``: a max all-reduce of each rank's per-point
    maximum, then a sum all-reduce of the shifted exponentials, exactly
    logsumexp(all S densities) - log S."""
    n = axis_size(mesh, axis)
    assert S % n == 0, f"S={S} must divide over {n} devices"
    source, zs_l = _sample_draws(model, seed, mesh, axis, zs)
    Fmean, Fvar = model._predict(Xnew, source, S // n, zs_l)
    l = model.sample_log_densities(Fmean, Fvar, model._as_input(Ynew))
    m_glob = all_reduce(torch.max(l, dim=0).values, mesh, axis, op="max")
    s_glob = all_reduce(torch.sum(torch.exp(l - m_glob[None]), dim=0), mesh,
                        axis)
    return m_glob + torch.log(s_glob) - torch.log(
        torch.tensor(float(S), dtype=l.dtype, device=l.device))


def _pad_mask_rows(model, Xs, Ys, mesh, axis, zs):
    """This rank's (X, Y, mask, zs) of the test rows, padded to a multiple
    of the axis; the mask is 1 on real rows (the evaluation paths'
    shared prologue)."""
    X_l, Y_l, mask, zs_l, _ = _local_rows(model, Xs, Ys, mesh, axis, zs)
    if mask is None:
        mask = torch.ones(X_l.shape[0], dtype=X_l.dtype, device=X_l.device)
    return X_l, Y_l, mask, zs_l


def _local_predict_y(model, X_l, S, seed, mesh, axis, zs_l):
    g = None if zs_l is not None else rank_generator(
        0 if seed is None else seed, axis_index(mesh, axis),
        model.X_data.device)
    mean, var = model.predict_y(X_l, S, generator=g, zs=zs_l)
    if mean.ndim == 2:        # models that squeeze the sample axis
        mean, var = mean[None], var[None]
    return mean.double(), var.double()


@torch.no_grad()
def dp_evaluate_regression(model, Xs, Ys, Y_std, S: int, seed, mesh,
                           axis: str = "data", zs=None):
    """Test RMSE and log-likelihood with the reference harness's
    definitions (``training.loop.evaluate_regression``), the test rows
    split over ``axis``: each rank predicts its rows with all S samples
    (from ``rank_generator(seed, index)``, or ``zs``), and one all-reduce
    of three masked sums (squared error, log-likelihood, rows) gives the
    metrics; computed in float64."""
    X_l, Y_l, mask, zs_l = _pad_mask_rows(model, Xs, Ys, mesh, axis, zs)
    mean_SND, var_SND = _local_predict_y(model, X_l, S, seed, mesh, axis,
                                         zs_l)
    Y_l, mask = Y_l.double(), mask.double()
    Y_std = torch.as_tensor(Y_std, dtype=torch.float64, device=Y_l.device)
    mean_ND = torch.mean(mean_SND, dim=0)
    sse = torch.sum(mask[:, None] * (Y_l - mean_ND) ** 2)
    ys, mu = Y_l[None] * Y_std, mean_SND * Y_std
    sd = torch.sqrt(var_SND) * Y_std
    logp = (-0.5 * ((ys - mu) / sd) ** 2 - torch.log(sd)
            - 0.5 * torch.log(torch.tensor(2 * torch.pi, dtype=torch.float64)))
    loglik_ND = torch.logsumexp(logp, dim=0) - torch.log(
        torch.tensor(float(mean_SND.shape[0]), dtype=torch.float64))
    ll = torch.sum(mask[:, None] * loglik_ND)
    rows = torch.sum(mask) * Y_l.shape[1]
    sse, ll, rows = all_reduce_many([sse, ll, rows], mesh, axis)
    loglik = float(ll / rows)
    return {"rmse": float(torch.mean(Y_std) * torch.sqrt(sse / rows)),
            "nll": -loglik, "loglik": loglik}


@torch.no_grad()
def dp_evaluate_classification(model, Xs, Ys, S: int, seed, mesh,
                               axis: str = "data", zs=None):
    """Test accuracy and mean log predictive probability
    (``training.loop.evaluate_classification``'s definitions) with the
    test rows split over ``axis``: each rank averages its rows' S
    ``predict_y`` means into class probabilities, and one all-reduce of
    three masked sums (hits, log p(true class) clamped at 1e-12, rows)
    gives the metrics.  ``Ys``: integer labels, (N, 1)."""
    X_l, Y_l, mask, zs_l = _pad_mask_rows(model, Xs, Ys, mesh, axis, zs)
    mean_SND, _ = _local_predict_y(model, X_l, S, seed, mesh, axis, zs_l)
    probs = torch.mean(mean_SND, dim=0)                      # (n_l, K)
    labels = Y_l[:, 0].long()
    mask = mask.double()
    hit = (torch.argmax(probs, dim=1) == labels).double()
    p_true = torch.clamp(torch.gather(probs, 1, labels[:, None])[:, 0],
                         min=1e-12)
    hits, ll, rows = all_reduce_many(
        [torch.sum(mask * hit), torch.sum(mask * torch.log(p_true)),
         torch.sum(mask)], mesh, axis)
    loglik = float(ll / rows)
    return {"accuracy": float(hits / rows), "loglik": loglik,
            "nll": -loglik}


def sp_elbo(model, X, Y, seed, mesh, axis: str = "sample",
            batch_size: Optional[int] = None, zs=None):
    """The ELBO with the MC samples split over ``axis``: each rank
    propagates its S / n samples and the per-sample variational
    expectations average over the ranks (an all-reduce divided by n), so
    the value is the S-sample estimate, with the draws of the
    single-process ELBO; the KL counts once.  ``zs`` (one (S, N, D_l)
    array a layer, split on its leading axis) pins the draws."""
    n = axis_size(mesh, axis)
    X, Y = model._as_input(X), model._as_input(Y)
    B = batch_size or X.shape[0]
    if zs is not None:
        zs_l = [shard_along(torch.as_tensor(z), mesh, axis) for z in zs]
        source, S_local = None, zs_l[0].shape[0]
    else:
        S = model.num_samples
        if S % n != 0:
            raise ValueError(f"num_samples={S} must divide the '{axis}' "
                             f"mesh axis ({n})")
        source, zs_l = _sample_draws(model, seed, mesh, axis, None)
        S_local = S // n
    Fmean, Fvar = model._predict(X, source, S_local, zs_l)
    ve_s = model.likelihood.variational_expectations(Fmean, Fvar, Y)
    ve = all_reduce(torch.mean(ve_s, dim=0), mesh, axis, op="mean")
    return torch.sum(ve) * (model.num_data / B) - _kl_sum(model)


def _dp_sp_local_loss(model, X, Y, generator, S_local, B, n_dev_total,
                      n_samp):
    """A rank's loss in the data x sample split: summed over both axes it
    is -elbo with the likelihood averaged over the n_samp sample groups
    and the KL counted once."""
    Fmean, Fvar = model._predict(X, generator, S_local)
    ve_s = model.likelihood.variational_expectations(Fmean, Fvar, Y)
    total = torch.sum(torch.mean(ve_s, dim=0))
    return -(total * (model.num_data / B) / n_samp
             - (_kl_sum(model) - log_prior(model)) / n_dev_total)


def make_dp_sp_scan_train_step(optimizer, mesh, data_axis: str = "data",
                               sample_axis: str = "sample",
                               batch_size: Optional[int] = None,
                               inner_steps: int = 10):
    """Chunk ``chunk(model, generator) -> loss`` over a 2-D (data x
    sample) mesh: the minibatch rows split over ``data_axis`` and the S
    samples over ``sample_axis``.  ``generator`` is the data index's
    (every rank of a data column draws the same minibatch and the same
    normals of all S samples, and keeps its block of them); one
    all-reduce over the mesh a step sums the loss and the gradients.
    Dispatch as :func:`make_dp_scan_train_step`."""
    n_data = axis_size(mesh, data_axis)
    n_samp = axis_size(mesh, sample_axis)
    si = axis_index(mesh, sample_axis)
    local_bs = None if batch_size is None else max(1, batch_size // n_data)
    params = optimizer.params

    @torch.no_grad()
    def body(model, generator):
        source = SampleShard(generator, n_samp, si)
        X_l = shard_along(model.X_data, mesh, data_axis)
        Y_l = shard_along(model.Y_data, mesh, data_axis)
        n_local = X_l.shape[0]
        S_local = max(1, model.num_samples // n_samp)
        losses = []
        for _ in range(inner_steps):
            if local_bs is not None and local_bs < n_local:
                idx = randint(n_local, (local_bs,), source, X_l.device)
                X, Y, B = X_l[idx], Y_l[idx], local_bs * n_data
            else:
                X, Y, B = X_l, Y_l, n_local * n_data
            loss, grads = value_and_grads(
                lambda: _dp_sp_local_loss(model, X, Y, source, S_local, B,
                                          n_data * n_samp, n_samp), params)
            all_reduce_sum_([loss] + grads, mesh)
            torch._foreach_add_(params,
                                optimizer.update(grads, optimizer.state))
            losses.append(loss)
        return torch.stack(losses).mean()

    return _chunk(body, optimizer, torch.zeros_like(optimizer.state.count),
                  "data x sample parallel training", inner_steps, mesh)

