"""Deep GP with the doubly-stochastic Monte-Carlo ELBO and prediction
surface, and the quadrature bound.

Counterpart of ``doubly_stochastic_dgp_tpu/models/dgp.py`` (``DGPBase``
propagation, the training objective and prediction, ``DGP.build``,
``DGPQuad``).  JAX
splits one PRNG key per layer; here each layer draws its unit normals in
order from one ``torch.Generator`` on the model's device, so the two
packages agree only through fixed draws (``zs``).  With ``remat`` (a
build-time snapshot of ``Config.remat``) each layer's conditional is
recomputed in the backward pass (``torch.utils.checkpoint``) instead of
keeping its intermediates; the layer's normals are drawn before the
checkpointed call, so values and gradients are the same bits as without.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import Config, resolve_device
from ..ops.quadrature import mvhermgauss
from .initializations import init_layers_linear
from .mean_functions import Zero

__all__ = ["DGPBase", "DGP", "DGPQuad"]


class DGPBase(nn.Module):
    """A stack of layers, a likelihood and the training data buffers."""

    # True on models whose objective is evaluated on the whole stored
    # training set (the collapsed bounds are not sums of per-datum terms):
    # the trainer rejects a minibatch size for them
    full_batch_bound = False

    def __init__(self, likelihood, layers, X, Y, num_samples=1,
                 num_data=None, remat=False):
        """The layers as built (on the host in float64 by the
        initializers); move the model with ``.to(device=..., dtype=...)``,
        or use :meth:`make`."""
        super().__init__()
        X = torch.as_tensor(X)
        Y = torch.as_tensor(Y)
        if X.shape[0] != Y.shape[0]:
            raise ValueError(f"X and Y must have the same number of rows; "
                             f"got X {tuple(X.shape)} vs Y {tuple(Y.shape)}")
        self.likelihood = likelihood
        self.layers = nn.ModuleList(layers)
        self.register_buffer("X_data", X)
        self.register_buffer("Y_data", Y)
        self.num_samples = int(num_samples)
        self.num_data = int(num_data or X.shape[0])
        self.remat = bool(remat)

    @classmethod
    def make(cls, X, Y, likelihood, layers, num_samples=1, num_data=None,
             config=Config(), device=None, **kwargs):
        """A model of ``layers`` (built by an initializer with the same
        ``config``), moved to ``device`` (CUDA unless given) in
        ``config.dtype``: the JAX ``make``."""
        device = resolve_device(device)
        model = cls(likelihood, layers, np.asarray(X, dtype=np.float64),
                    np.asarray(Y, dtype=np.float64), num_samples=num_samples,
                    num_data=num_data, remat=config.remat, **kwargs)
        return model.to(device=device, dtype=config.dtype)

    def _as_input(self, A):
        return torch.as_tensor(A, dtype=self.X_data.dtype,
                               device=self.X_data.device)

    def propagate(self, X, generator=None, S=1, zs=None, full_cov=False):
        """Tile X to (S, N, D) and sample through every layer; returns
        (Fs, Fmeans, Fvars), one entry per layer, each variance (S, N,
        D_l), or (S, N, N, D_l) with ``full_cov``.  ``zs`` (one per layer,
        broadcastable to (S, N, D_l)) replaces the random draws."""
        return self._propagate_layers(self.layers, X, generator, S, zs,
                                      full_cov)

    def _propagate_layers(self, layers, X, generator, S, zs,
                          full_cov=False):
        X = self._as_input(X)
        F = X[None].expand(S, *X.shape)
        if zs is None:
            zs = [None] * len(layers)
        remat = self.remat and torch.is_grad_enabled()
        Fs, Fmeans, Fvars = [], [], []
        for layer, z in zip(layers, zs):
            if remat:
                # draw before the checkpointed call, so the recompute draws
                # nothing and needs no RNG state (whose save would read the
                # CUDA generator, which a graph capture refuses)
                z = layer.draw_z(F, generator) if z is None else z
                F, Fmean, Fvar = checkpoint(
                    layer.sample_from_conditional, F, z, None, full_cov,
                    use_reentrant=False, preserve_rng_state=False)
            else:
                F, Fmean, Fvar = layer.sample_from_conditional(
                    F, z=z, generator=generator, full_cov=full_cov)
            Fs.append(F)
            Fmeans.append(Fmean)
            Fvars.append(Fvar)
        return Fs, Fmeans, Fvars

    def _predict(self, X, generator=None, S=1, zs=None, full_cov=False):
        _, Fmeans, Fvars = self.propagate(X, generator=generator, S=S,
                                          zs=zs, full_cov=full_cov)
        return Fmeans[-1], Fvars[-1]

    # -- training objective ---------------------------------------------------
    def E_log_p_Y(self, X, Y, generator=None, zs=None):
        """MC estimate of E_q[log p(y | f_L)] over ``num_samples`` draws,
        averaged over the samples: (N, D)."""
        Fmean, Fvar = self._predict(X, generator=generator,
                                    S=self.num_samples, zs=zs)
        var_exp = self.likelihood.variational_expectations(
            Fmean, Fvar, self._as_input(Y))
        return torch.mean(var_exp, dim=0)

    def elbo(self, X=None, Y=None, generator=None, zs=None):
        """The doubly-stochastic ELBO on the batch (X, Y) (default: the
        stored training set): (num_data / batch) * sum E[log p] minus the
        sum of the layers' KL terms."""
        X = self.X_data if X is None else X
        Y = self.Y_data if Y is None else Y
        L = torch.sum(self.E_log_p_Y(X, Y, generator=generator, zs=zs))
        KL = sum(layer.KL() for layer in self.layers)
        return L * (self.num_data / X.shape[0]) - KL

    def loss(self, X=None, Y=None, generator=None, zs=None):
        return -self.elbo(X, Y, generator=generator, zs=zs)

    def _default_generator(self, generator, zs):
        if generator is None and zs is None:
            generator = torch.Generator(device=self.X_data.device)
            generator.manual_seed(0)
        return generator

    @torch.no_grad()
    def predict_f(self, Xnew, S, generator=None, zs=None):
        """Final-layer moments, (S, N, D) each."""
        return self._predict(Xnew, self._default_generator(generator, zs),
                             S, zs)

    @torch.no_grad()
    def predict_f_full_cov(self, Xnew, S, generator=None, zs=None):
        """Final-layer mean (S, N, D) and covariance (S, N, N, D)."""
        return self._predict(Xnew, self._default_generator(generator, zs),
                             S, zs, full_cov=True)

    @torch.no_grad()
    def predict_all_layers(self, Xnew, S, generator=None, zs=None):
        """(Fs, Fmeans, Fvars) of every layer, diagonal variances."""
        return self.propagate(Xnew, self._default_generator(generator, zs),
                              S, zs)

    @torch.no_grad()
    def predict_all_layers_full_cov(self, Xnew, S, generator=None, zs=None):
        """(Fs, Fmeans, Fvars) of every layer, full covariances."""
        return self.propagate(Xnew, self._default_generator(generator, zs),
                              S, zs, full_cov=True)

    # per-sample y-space hooks: the likelihood's by default; a model whose
    # final-layer outputs are not one-to-one with the targets overrides them
    def sample_predict_y(self, Fmean, Fvar):
        return self.likelihood.predict_mean_and_var(Fmean, Fvar)

    def sample_log_densities(self, Fmean, Fvar, Ynew):
        return self.likelihood.predict_density(Fmean, Fvar, Ynew)

    @torch.no_grad()
    def predict_y(self, Xnew, S, generator=None, zs=None):
        """Predictive y moments per sample, (S, N, D) each."""
        Fmean, Fvar = self._predict(
            Xnew, self._default_generator(generator, zs), S, zs)
        return self.sample_predict_y(Fmean, Fvar)

    @torch.no_grad()
    def predict_density(self, Xnew, Ynew, S, generator=None, zs=None):
        """MC mixture predictive log density: logsumexp over the S
        samples, (N, D)."""
        Fmean, Fvar = self._predict(
            Xnew, self._default_generator(generator, zs), S, zs)
        l = self.sample_log_densities(Fmean, Fvar, self._as_input(Ynew))
        return torch.logsumexp(l - math.log(S), dim=0)


class DGP(DGPBase):
    """The paper's model: identity/PCA-initialized SVGP stack."""

    @classmethod
    def build(cls, X, Y, Z, kernels, likelihood, num_outputs=None,
              mean_function=None, white=False, num_samples=1,
              num_data=None, config=Config(), device=None):
        """Build on the host in float64, then move to ``device`` (CUDA
        unless given) in ``config.dtype``."""
        device = resolve_device(device)
        X = np.asarray(X)
        Y = np.asarray(Y)
        Z = np.asarray(Z)
        if Z.ndim != 2 or Z.shape[1] != X.shape[1]:
            raise ValueError(f"Z must be (M, D) with D = X's feature width "
                             f"{X.shape[1]}; got {Z.shape}")
        num_outputs = num_outputs or Y.shape[1]
        if mean_function is None:
            mean_function = Zero(num_outputs)
        layers = init_layers_linear(X, Y, Z, kernels,
                                    num_outputs=num_outputs,
                                    mean_function=mean_function,
                                    white=white, config=config)
        return cls.make(X, Y, likelihood, layers, num_samples=num_samples,
                        num_data=num_data, config=config, device=device)


class _Grids(nn.Module):
    """The per-layer quadrature grids as buffers named 0, 1, ... (so that
    the JAX path ``.gh_x[i]`` maps to ``gh_x.i``)."""

    def __init__(self, grids):
        super().__init__()
        for i, g in enumerate(grids):
            self.register_buffer(str(i), g)

    def __iter__(self):
        return iter(self._buffers.values())


class DGPQuad(DGPBase):
    """Gauss-Hermite quadrature over the inner layers in place of Monte
    Carlo: the inner layers' outputs are integrated on the product grid of
    H points a dimension, H ** D_quad nodes for D_quad inner outputs in
    all.  Deterministic (``E_log_p_Y`` draws nothing), and exponential in
    D_quad: the oracle of exactness tests."""

    def __init__(self, likelihood, layers, X, Y, num_samples=1,
                 num_data=None, remat=False, H=100):
        super().__init__(likelihood, layers, X, Y, num_samples=num_samples,
                         num_data=num_data, remat=remat)
        inner_dims = [layer.num_outputs for layer in self.layers[:-1]]
        self.H, self.D_quad = int(H), int(sum(inner_dims))
        gh_x, gh_w = mvhermgauss(self.H, self.D_quad)
        gh_x = gh_x * np.sqrt(2.0)                          # (H**Dq, Dq)
        gh_w = gh_w * np.pi ** (-0.5 * self.D_quad)         # (H**Dq,)
        # each layer's slice of the grid, (S, 1, d): broadcasts with (S, N,
        # d); the last layer's sample is not used
        zs, s = [], 0
        for d in inner_dims:
            zs.append(torch.as_tensor(gh_x[:, None, s:s + d]))
            s += d
        zs.append(torch.zeros(1, 1, 1, dtype=torch.float64))
        self.gh_x = _Grids(zs)
        self.register_buffer("gh_w", torch.as_tensor(gh_w))

    @classmethod
    def build(cls, X, Y, likelihood, layers, H=100, num_data=None,
              config=Config(), device=None):
        """The quadrature model of ``layers`` (built on the host, e.g. by
        ``init_layers_linear`` with the same ``config``), moved to
        ``device`` (CUDA unless given) in ``config.dtype``."""
        return cls.make(X, Y, likelihood, layers, num_data=num_data,
                        config=config, device=device, H=H)

    def E_log_p_Y(self, X, Y, generator=None, zs=None):
        """The quadrature estimate of E_q[log p(y | f_L)], (N, D): the
        final layer's expectation at every grid node, weighted.
        ``generator`` and ``zs`` are ignored: the grid takes their place."""
        _, Fmeans, Fvars = self.propagate(X, S=self.H ** self.D_quad,
                                          zs=list(self.gh_x))
        var_exp = self.likelihood.variational_expectations(
            Fmeans[-1], Fvars[-1], self._as_input(Y))        # (S, N, D)
        return torch.sum(var_exp * self.gh_w[:, None, None], dim=0)
