"""Data-parallel bounds and training for the collapsed DGPs.

Counterpart of ``doubly_stochastic_dgp_tpu/parallel/collapsed.py``.  The
Damianou bound (``models/damianou.py``) looks full-batch, every row
owning variational parameters q(H_l)[n], but it decomposes into per-row
sums: the psi statistics (psi0, psi1^T targets, psi2), the certain
branch's feature sums (Kdiag, Kuf Kuf^T, Kuf err), the targets' squared
sums, and the per-row correction and entropy terms.  So the rows split
over a mesh axis, the q(H) state with them (it lives and updates on its
own rank), and only one all-reduce a layer of the (M, M) and (M, D)
moment blocks and two scalars crosses ranks, after which every rank
assembles the same small collapsed algebra:

  1. per-rank moment sums over the rank's rows (the psi2 kernel runs on
     them),
  2. one all-reduce, then the replicated assembly (L, LB, c),
  3. per-rank correction and entropy sums, then a scalar all-reduce.

The generic ``DGPCollapsed`` propagates each rank's training rows
through its inner layers (S = 1) and has an SGPR final layer (the same
stages on the propagated moments) or a GPR one (the propagated means are
gathered and the exact N x N bound is computed on every rank).

Gradients follow the rule of ``parallel/mesh.py``: each rank
back-propagates its share (the bound over the axis's ranks) through the
all-reduces, whose backward all-reduces the incoming gradient, and one
all-reduce sums the replicated parameters' gradients.  The row-sharded
leaves (``h_mean``, ``h_var``, ``X_data``, ``Y_data``) are left out of
it: a rank's q(H) rows get their own rows' gradient, and their Adam
state stays on the rank.

A model on every rank may be whole (each function takes the rank's rows)
or placed by :func:`damianou_shard` / :func:`collapsed_shard` (its row
leaves hold the rank's rows only, and stay there through training).
"""

from __future__ import annotations

import copy
import math

import torch
from torch import nn

from ..ops.linalg import safe_cholesky, safe_cholesky_ladder, tri_solve
from ..utils.params import log_prior, owner_of
from .dp import dp_value_and_grads
from .mesh import (all_gather, all_reduce, all_reduce_many, axis_index,
                   axis_size, rank_generator, replicate, shard_along)

__all__ = ["damianou_specs", "damianou_shard", "dp_damianou_elbo",
           "make_dp_damianou_train_step", "collapsed_specs",
           "collapsed_shard", "dp_collapsed_elbo",
           "make_dp_collapsed_train_step"]

_ROW_LEAVES = ("h_mean", "h_var", "X_data", "Y_data")


def _is_row_leaf(name, t):
    return t.ndim >= 1 and any(r in name.split(".") for r in _ROW_LEAVES)


def damianou_specs(model, axis: str = "data"):
    """{parameter or buffer name: ``axis`` or None}, the JAX
    PartitionSpec tree's counterpart: the row-indexed leaves (the
    training rows and their q(H) state) split over ``axis``; everything
    else (kernels, Z, noise, likelihood) is replicated."""
    named = list(model.named_parameters()) + list(model.named_buffers())
    return {name: (axis if _is_row_leaf(name, t) else None)
            for name, t in named}


def _row_params(model):
    return [p for name, p in model.named_parameters()
            if _is_row_leaf(name, p)]


def damianou_shard(model, mesh, axis: str = "data"):
    """A copy of ``model`` placed on the mesh: its row leaves hold this
    rank's block of rows (q(H) state included), everything else is rank
    0's, broadcast.  The data-parallel functions then use the rows as
    they are."""
    n = axis_size(mesh, axis)
    if model.X_data.shape[0] % n != 0:
        raise ValueError(f"N={model.X_data.shape[0]} must divide the {n}-"
                         f"rank '{axis}' mesh axis")
    placed = copy.deepcopy(model)
    replicate(placed, mesh)
    with torch.no_grad():
        for name, p in list(placed.named_parameters()):
            if _is_row_leaf(name, p):
                owner, attr = owner_of(placed, name)
                setattr(owner, attr, nn.Parameter(
                    shard_along(p.detach(), mesh, axis).clone(),
                    requires_grad=p.requires_grad))
        for name, b in list(placed.named_buffers()):
            if _is_row_leaf(name, b):
                owner, attr = owner_of(placed, name)
                owner.register_buffer(attr,
                                      shard_along(b, mesh, axis).clone())
    placed.row_shard = (axis, n)
    return placed


def collapsed_specs(model, axis: str = "data"):
    """:func:`damianou_specs` for a generic ``DGPCollapsed`` (it has no
    q(H) leaves: only the stored rows split)."""
    return damianou_specs(model, axis)


def collapsed_shard(model, mesh, axis: str = "data"):
    """:func:`damianou_shard` for a generic ``DGPCollapsed``."""
    return damianou_shard(model, mesh, axis)


def _rows_of(model, mesh, axis):
    """(this rank's rows of a row leaf, the global row count): a placed
    model's leaves are the rows already; a whole model's are split."""
    n = axis_size(mesh, axis)
    if getattr(model, "row_shard", None) is not None:
        if model.row_shard != (axis, n):
            raise ValueError(f"the model is placed on {model.row_shard}, "
                             f"not on ('{axis}', {n})")
        return (lambda t: t), model.X_data.shape[0] * n
    N = model.X_data.shape[0]
    assert N % n == 0, f"N={N} must divide the {n}-device mesh"
    return (lambda t: None if t is None else shard_along(t, mesh, axis)), N


def _layer_moments(layer, mu, sv, T):
    """Stage 1, one layer's sums over this rank's rows: (phi (M, n_l),
    P2 (M, M), P1T (M, D_out), sum of squared targets, sum of psi0): phi
    is Kuf (certain inputs, targets less the mean function) or psi1^T
    (uncertain), P2 = sum_n phi_n phi_n^T (psi2 when uncertain)."""
    from ..ops.psi_stats import psi_statistics

    Z = layer.Z.value
    if sv is None:
        err = T - layer.mean_function(mu)
        phi = layer.kern.K(Z, mu)                              # (M, n)
        return (phi, phi @ phi.T, phi @ err, torch.sum(err ** 2),
                torch.sum(layer.kern.Kdiag(mu)))
    psi0, psi1, psi2s = psi_statistics(layer.kern, mu, sv, Z,
                                       layer.psi2_impl)
    return psi1.T, psi2s, psi1.T @ T, torch.sum(T ** 2), torch.sum(psi0)


def _assemble(layer, P2, P1T, sigma2):
    """Stage 2 (replicated): (L, LB, c, tr AA^T), AA^T in the
    symmetrized two-solve form of ``SGPRLayer._common`` (no jitter on P2:
    it would raise the bound; the ladder's jitter on B only lowers it)."""
    mode = layer.solve_mode
    L = safe_cholesky(layer.kern.K(layer.Z.value), layer.jitter)
    tmp = tri_solve(L, P2, lower=True, mode=mode)
    AAT = tri_solve(L, tmp.T, lower=True, mode=mode) / sigma2
    AAT = 0.5 * (AAT + AAT.T)
    I = torch.eye(P2.shape[0], dtype=P2.dtype, device=P2.device)
    LB = safe_cholesky_ladder(AAT + I)
    half = tri_solve(L, P1T, lower=True, mode=mode)
    c = tri_solve(LB, half, lower=True, mode=mode) / sigma2
    return L, LB, c, torch.trace(AAT)


def _layer_bound(N, Do, sigma2, LB, c, sum_t2, sum_phi0, tr_AAT):
    """The collapsed bound of one layer, certain or uncertain inputs (term
    by term ``SGPRLayer.build_likelihood``)."""
    bound = -0.5 * N * Do * torch.log(2 * math.pi * sigma2)
    bound = bound - Do * torch.sum(torch.log(torch.diagonal(LB)))
    bound = bound - 0.5 * sum_t2 / sigma2
    bound = bound + 0.5 * torch.sum(c ** 2)
    return bound - 0.5 * Do * (sum_phi0 / sigma2 - tr_AAT)


def _moment_bound(layer, mu, sv, T, sigma2, N, mesh, axis):
    """Stages 1 and 2 of one layer: (its bound, phi, L, LB)."""
    phi, *moments = _layer_moments(layer, mu, sv, T)
    # one all-reduce a layer: (M, M) + (M, Do) + 2 scalars
    P2, P1T, sum_t2, sum_phi0 = all_reduce_many(moments, mesh, axis)
    L, LB, c, tr_AAT = _assemble(layer, P2, P1T, sigma2)
    bound = _layer_bound(N, T.shape[1], sigma2, LB, c, sum_t2, sum_phi0,
                         tr_AAT)
    return bound, phi, L, LB


def dp_damianou_elbo(model, mesh, axis: str = "data"):
    """The Damianou bound with the rows over ``axis``: ``model.elbo()`` of
    one process up to the order of the sums."""
    rows, N = _rows_of(model, mesh, axis)
    total = 0.0
    L_layers = len(model.layers)
    for l, layer in enumerate(model.layers):
        mu, sv, T, var_l = model._layer_data(l)
        mu, sv, T = rows(mu), rows(sv), rows(T)
        sigma2 = layer.set_data(mu, sv, T, var_l)._bound_variance()
        g, phi, Lc, LB = _moment_bound(layer, mu, sv, T, sigma2, N, mesh,
                                       axis)
        if l < L_layers - 1:
            # stage 3: the per-row corrections G_n = V phi_n, V = LB^-1
            # L^-1 / sigma2, on this rank's rows, then a scalar all-reduce
            s = rows(model.h_var[l].value)
            I = torch.eye(Lc.shape[0], dtype=Lc.dtype, device=Lc.device)
            Vh = tri_solve(Lc, I, lower=True, mode=layer.solve_mode)
            V = tri_solve(LB, Vh, lower=True, mode=layer.solve_mode) / sigma2
            diagGtG = torch.sum((V @ phi) ** 2, dim=0)          # (n_l,)
            corr = (-0.5 * torch.sum(s) / sigma2
                    + 0.5 * torch.sum(diagGtG[:, None] * s))
            ent = 0.5 * torch.sum(torch.log(2.0 * math.pi * math.e * s))
            g = g + all_reduce(corr + ent, mesh, axis)
        total = total + g
    return total


def dp_collapsed_elbo(model, mesh, seed=None, axis: str = "data", zs=None):
    """The generic ``DGPCollapsed`` bound with the rows over ``axis``.

    Each rank propagates its own training rows through the inner layers
    (S = 1) with ``rank_generator(seed, index)`` (seed 0 by default), or
    with its rows of ``zs`` (one (1, N, D_l) array a layer, or (1, 1,
    D_l) broadcast; with them the value is the single-process bound on
    the same draws), then:

    - SGPR final layer: psi-statistic moments over the rank's rows, one
      all-reduce, the replicated collapsed algebra (the propagated
      variance always takes the psi branch, as ``DGPCollapsed.elbo``);
    - GPR final layer: no moment decomposition; the propagated means and
      targets are gathered (N x D, small) and the exact bound computed
      on every rank.

    The inner KL terms are replicated and count once.  ``DGPHeinonen``
    raises ``NotImplementedError``: its GPMC latents are replicated, not
    row-sharded, and its bound is dense N x N algebra."""
    from ..models.layers import GPRLayer, SGPRLayer
    from ..models.zoo import DGPHeinonen

    if isinstance(model, DGPHeinonen):
        raise NotImplementedError(
            "dp_collapsed_elbo does not support DGPHeinonen: its GPMC "
            "latents are replicated, not row-sharded; compute its "
            "log_posterior on one device (the bound is dense N x N).")
    rows, N = _rows_of(model, mesh, axis)
    last = model.layers[-1]
    assert isinstance(last, (GPRLayer, SGPRLayer)), type(last)
    X_l, Y_l = rows(model.X_data), rows(model.Y_data)
    if zs is not None:
        zs = [torch.as_tensor(z, dtype=X_l.dtype, device=X_l.device)
              for z in zs]
        # a layer's (1, N, D) draws split by rows; (1, 1, D) broadcast
        zs = [z if z.shape[1] == 1 else shard_along(z, mesh, axis, dim=1)
              for z in zs]
        generator = None
    else:
        generator = rank_generator(0 if seed is None else seed,
                                   axis_index(mesh, axis), X_l.device)
    _, ms, vs = model.inner_layers_propagate(X_l, generator, zs=zs)
    mu, sv = ms[-1][0], vs[-1][0]
    sigma2_raw = model.likelihood.variance.value
    KL = sum((layer.KL() for layer in model.layers[:-1]),
             torch.zeros((), dtype=mu.dtype, device=mu.device))
    if isinstance(last, GPRLayer):
        mu_full = all_gather(mu, mesh, axis)
        Y_full = all_gather(Y_l, mesh, axis)
        return last.set_data(mu_full, None, Y_full,
                             sigma2_raw).build_likelihood() - KL
    sigma2 = last.set_data(mu, sv, Y_l, sigma2_raw)._bound_variance()
    bound, _, _, _ = _moment_bound(last, mu, sv, Y_l, sigma2, N, mesh, axis)
    return bound - KL


def make_dp_collapsed_train_step(optimizer, mesh, axis: str = "data"):
    """Step ``step(model, seed=None) -> loss``: one Adam update in place
    on -(``dp_collapsed_elbo`` + log prior) under the gradient rule (pass
    a fresh ``seed`` a call: it draws the inner propagation)."""

    @torch.no_grad()
    def step(model, seed=None):
        loss, grads = dp_value_and_grads(
            lambda: -(dp_collapsed_elbo(model, mesh, seed=seed, axis=axis)
                      + log_prior(model)),
            optimizer.params, mesh, axis, local=_row_params(model))
        torch._foreach_add_(optimizer.params,
                            optimizer.update(grads, optimizer.state))
        return loss

    return step


def make_dp_damianou_train_step(optimizer, mesh, axis: str = "data"):
    """Step ``step(model) -> loss``: one Adam update in place on
    -(``dp_damianou_elbo`` + log prior) under the gradient rule: the
    replicated hyperparameters take the summed gradient, the q(H) rows
    their own rank's (their Adam state stays on the rank)."""

    @torch.no_grad()
    def step(model):
        loss, grads = dp_value_and_grads(
            lambda: -(dp_damianou_elbo(model, mesh, axis=axis)
                      + log_prior(model)),
            optimizer.params, mesh, axis, local=_row_params(model))
        torch._foreach_add_(optimizer.params,
                            optimizer.update(grads, optimizer.state))
        return loss

    return step
