"""Natural-gradient steps on the Gaussian variational parameters.

Counterpart of ``doubly_stochastic_dgp_tpu/training/natgrad.py``
(``natgrad_update``, ``NaturalGradient``).  For q(u) = N(m, S), S = L L^T
per output dimension, with xi = (m, L) the stored parameters, eta = (m, S
+ m m^T) the expectation parameters and theta = (S^-1 m, -S^-1 / 2) the
natural ones, a step on a loss is theta <- theta - gamma dloss/deta, where
dloss/deta is the pullback of dloss/dxi through eta -> xi (Salimbeni,
Eleftheriadis & Hensman, AISTATS 2018).

The JAX package maps one output dimension with ``vmap``; here every
matrix op is batched over the D output dimensions, (D, M, M), and every
Cholesky is the port's ``safe_cholesky``, which picks its jitter rung per
batch element as the ``vmap`` does.  The pullback through eta -> xi is in
closed form (the Cholesky pullback on the factor of the eta -> xi map,
``ops/linalg.py::_chol_pullback``): ``torch.func.vjp`` cannot trace the
port's Cholesky, an old-style ``autograd.Function``.  A step that leaves
an output dimension's (m, L) non-finite keeps the old one, chosen with
``torch.where``: nothing is read on the host, so a step captures in a CUDA
graph.  The JAX update pins full-precision matmuls; the port never enables
TF32, so every product here is full fp32 (or f64) already.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..ops.linalg import _chol_pullback, inv_lower, safe_cholesky

__all__ = ["NaturalGradient", "natgrad_update", "natural_leaves",
           "natural_step"]


def _sym(A):
    return 0.5 * (A + A.mT)


def _chol_inv(L):
    """S^-1 from a Cholesky factor L of S, batched: Li^T Li."""
    Li = inv_lower(L)
    return Li.mT @ Li


@torch.no_grad()
def natgrad_update(q_mu, q_sqrt, dq_mu, dq_sqrt, gamma, jitter=1e-12,
                   rejected=None):
    """One natural-gradient step (minimization) on (q_mu, q_sqrt).

    q_mu (M, D), q_sqrt (D, M, M) lower, and their loss gradients dq_mu,
    dq_sqrt (lower-triangular support); ``jitter`` is the layer's.
    Returns the new (q_mu, q_sqrt); an output dimension whose new (m, L)
    is not finite keeps its old one.  ``rejected``: a 0-dim int64 tensor
    on the device to which the number of such output dimensions is
    added."""
    m, L = q_mu.mT, q_sqrt                                   # (D, M), (D, M, M)
    dm, dL = dq_mu.mT, dq_sqrt
    S = L @ L.mT
    mm = m[:, :, None] * m[:, None, :]
    eta2 = S + mm
    # dloss/deta: the pullback through eta -> xi = (eta1, chol(sym(eta2) -
    # eta1 eta1^T)) at (m, eta2)
    Lx = safe_cholesky(_sym(_sym(eta2) - mm), jitter)
    deta2 = _chol_pullback(Lx, dL)                           # symmetric
    deta1 = dm - 2.0 * (deta2 @ m[:, :, None])[..., 0]
    # the natural parameters, stepped
    Sinv = _chol_inv(L)
    theta1 = (Sinv @ m[:, :, None])[..., 0] - gamma * deta1
    theta2 = -0.5 * Sinv - gamma * deta2
    # back to xi: S = (-2 theta2)^-1, m = S theta1
    Lp = safe_cholesky(_sym(-2.0 * theta2), jitter)
    S_new = _chol_inv(Lp)
    m_new = (S_new @ theta1[:, :, None])[..., 0]
    L_new = safe_cholesky(_sym(S_new), jitter)
    ok = (torch.isfinite(m_new).all(dim=-1)
          & torch.isfinite(L_new).all(dim=-1).all(dim=-1))   # (D,)
    if rejected is not None:
        rejected.add_((~ok).sum())
    m_out = torch.where(ok[:, None], m_new, m)
    L_out = torch.where(ok[:, None, None], L_new, L)
    return m_out.mT, L_out


def natural_leaves(model, layers):
    """The (q_mu, q_sqrt) unconstrained tensors of ``model.layers[i]`` for
    i in ``layers``, in the order :func:`natural_step` takes gradients."""
    return [t for i in layers
            for t in (model.layers[i].q_mu.unconstrained,
                      model.layers[i].q_sqrt.unconstrained)]


def natural_step(model, loss, layers, gamma, rejected=None, grads=None):
    """A natural-gradient step in place on the (q_mu, q_sqrt) of each of
    ``model.layers[i]`` for i in ``layers``, from ``loss`` (a 0-dim tensor
    with its autograd graph) at the current parameters, or from its
    gradients ``grads`` in :func:`natural_leaves` (``loss`` then
    unused)."""
    picked = [model.layers[i] for i in layers]
    if grads is None:
        grads = torch.autograd.grad(loss, natural_leaves(model, layers))
    with torch.no_grad():
        for k, layer in enumerate(picked):
            # identity bijector: the unconstrained gradient is dloss/dm;
            # triangular bijector: it is tril-masked, dloss/dL
            m_new, L_new = natgrad_update(
                layer.q_mu.value, layer.q_sqrt.value, grads[2 * k],
                torch.tril(grads[2 * k + 1]), gamma, jitter=layer.jitter,
                rejected=rejected)
            layer.q_mu.unconstrained.copy_(m_new)
            layer.q_sqrt.unconstrained.copy_(torch.tril(L_new))
    return model


class NaturalGradient:
    """Natural-gradient optimizer over the (q_mu, q_sqrt) of the layers
    ``var_layers`` (the reference's ``var_list``)."""

    def __init__(self, gamma: float, var_layers: Sequence[int] = (-1,)):
        self.gamma = gamma
        self.var_layers = tuple(var_layers)

    def step(self, model, loss_fn: Callable):
        """One step in place from ``loss_fn(model)``, a 0-dim loss (for
        example the negative ELBO at fixed draws); returns the model."""
        with torch.enable_grad():
            loss = loss_fn(model)
            return natural_step(model, loss, self.var_layers, self.gamma)
