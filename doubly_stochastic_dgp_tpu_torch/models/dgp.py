"""Deep GP with the doubly-stochastic Monte-Carlo ELBO and prediction
surface.

Counterpart of ``doubly_stochastic_dgp_tpu/models/dgp.py`` (``DGPBase``
propagation, the training objective and prediction, ``DGP.build``).  JAX
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
from .initializations import init_layers_linear
from .mean_functions import Zero

__all__ = ["DGPBase", "DGP"]


class DGPBase(nn.Module):
    """A stack of layers, a likelihood and the training data buffers."""

    # True on models whose objective is evaluated on the whole stored
    # training set (the collapsed bounds are not sums of per-datum terms):
    # the trainer rejects a minibatch size for them
    full_batch_bound = False

    def __init__(self, likelihood, layers, X, Y, num_samples=1,
                 num_data=None, remat=False):
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
        model = cls(likelihood, layers, np.asarray(X, dtype=np.float64),
                    np.asarray(Y, dtype=np.float64),
                    num_samples=num_samples, num_data=num_data,
                    remat=config.remat)
        return model.to(device=device, dtype=config.dtype)
