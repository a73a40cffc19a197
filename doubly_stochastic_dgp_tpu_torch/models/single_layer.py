"""Single-layer GP models: SVGP (uncollapsed variational), GPR (exact),
SGPR (collapsed Titsias) and GPRFITC.

Counterpart of ``doubly_stochastic_dgp_tpu/models/single_layer.py``: the
baselines the reference's UCI notebook compares the DGP against (gpflow's
GPR, SGPR, SVGP and GPRFITC).  Each exposes ``log_likelihood()`` (the
training objective, ELBO or exact marginal), ``elbo`` with the trainer's
signature, ``predict_f(_full_cov)``, ``predict_y`` and
``predict_density``; GPR, SGPR and GPRFITC set ``full_batch_bound``, so
``fit`` refuses a minibatch for them and turns its guard on.  Their
predictions are deterministic: ``predict_y`` and ``predict_density``
accept ``S`` and ``generator`` for ``make_server`` and ignore them.
Each ``build`` works on the host in float64 and moves the model to
``device`` (CUDA unless given) in ``config.dtype``; the layer numerics
(``jitter``, ``solve_mode``) come from ``config``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..config import Config, resolve_device
from ..ops.likelihoods import Gaussian
from ..ops.linalg import cholesky_nan, safe_cholesky, tri_solve
from ..utils.params import Param
from .dgp import DGPBase
from .layers import GPRLayer, SGPRLayer, SVGPLayer
from .mean_functions import Zero

__all__ = ["SVGP", "GPR", "SGPR", "GPRFITC"]


class SVGP(DGPBase):
    """Sparse variational GP (Hensman et al.): a 1-layer DGP.  Its bound
    has no Monte-Carlo error, since a single layer's conditional moments
    are deterministic."""

    @classmethod
    def build(cls, X, Y, kern, likelihood, Z, num_latent=None, white=True,
              mean_function=None, num_data=None, config=Config(),
              device=None):
        X = np.asarray(X, dtype=np.float64)
        Y = np.asarray(Y, dtype=np.float64)
        num_latent = num_latent or Y.shape[1]
        layer = SVGPLayer(kern, Z, num_latent,
                          mean_function or Zero(num_latent), white=white,
                          config=config)
        return cls.make(X, Y, likelihood, [layer], num_samples=1,
                        num_data=num_data, config=config, device=device)

    def log_likelihood(self, X=None, Y=None):
        """The ELBO on (X, Y) (default: the training set); the sample it
        draws is not used, so it takes fixed zeros and no generator."""
        return self.elbo(X, Y, zs=[0.0])

    def predict_f(self, Xnew, S=1, generator=None, zs=None):
        return super().predict_f(Xnew, S, generator, zs)

    def predict_f_full_cov(self, Xnew, S=1, generator=None, zs=None):
        return super().predict_f_full_cov(Xnew, S, generator, zs)

    def predict_y(self, Xnew, S=1, generator=None, zs=None):
        """Predictive y moments, (N, D) each (the sample axis dropped)."""
        m, v = super().predict_y(Xnew, S, generator, zs)
        return m[0], v[0]

    def predict_density(self, Xnew, Ynew, S=1, generator=None, zs=None):
        return super().predict_density(Xnew, Ynew, S, generator, zs)


class DeterministicPredictions:
    """The deterministic prediction API over ``predict_f`` of GPR, SGPR,
    GPRFITC and their caches: ``predict_y`` and ``predict_density`` take
    ``S`` and ``generator`` for ``make_server`` and ignore them; inputs
    take the dtype and device of ``_input_like()``."""

    def _as_input(self, A):
        like = self._input_like()
        return torch.as_tensor(A, dtype=like.dtype, device=like.device)

    def elbo(self, X=None, Y=None, generator=None, zs=None):
        """The objective on the stored training set (the arguments, the
        trainer's, are ignored)."""
        return self.log_likelihood()

    def predict_f_full_cov(self, Xnew):
        return self.predict_f(Xnew, full_cov=True)

    @torch.no_grad()
    def predict_y(self, Xnew, S=None, generator=None):
        m, v = self.predict_f(Xnew)
        return self.likelihood.predict_mean_and_var(m, v)

    @torch.no_grad()
    def predict_density(self, Xnew, Ynew, S=None, generator=None):
        m, v = self.predict_f(Xnew)
        return self.likelihood.predict_density(m, v, self._as_input(Ynew))


class _SingleLayerGP(DeterministicPredictions, nn.Module):
    """The shared shell of GPR, SGPR and GPRFITC: the training data as
    buffers (each subclass sets its fields, then its Gaussian
    likelihood)."""

    full_batch_bound = True     # an exact or collapsed marginal

    def __init__(self, X, Y):
        super().__init__()
        self.register_buffer("X_data", torch.as_tensor(X))
        self.register_buffer("Y_data", torch.as_tensor(Y))

    def _finish(self, config, device):
        return self.to(device=resolve_device(device), dtype=config.dtype)

    def _input_like(self):
        return self.X_data


class _CollapsedSingleLayer(_SingleLayerGP):
    """GPR and SGPR: a collapsed layer bound to the stored data."""

    def __init__(self, layer, likelihood, X, Y):
        super().__init__(X, Y)
        self.layer = layer
        # the likelihood last, as the JAX field order (``summary``'s rows)
        self.likelihood = likelihood

    def _bound_layer(self):
        return self.layer.set_data(self.X_data, None, self.Y_data,
                                   self.likelihood.variance.value)

    def log_likelihood(self, X=None, Y=None):
        return self._bound_layer().build_likelihood()

    @torch.no_grad()
    def predict_f(self, Xnew, full_cov=False):
        return self._bound_layer().conditional_ND(self._as_input(Xnew),
                                                  full_cov=full_cov)


class GPR(_CollapsedSingleLayer):
    """Exact GP regression on a ``GPRLayer`` (the reference tests' gpflow
    GPR oracle)."""

    @classmethod
    def build(cls, X, Y, kern, mean_function=None, noise_variance=1.0,
              config=Config(), device=None):
        X = np.asarray(X, dtype=np.float64)
        Y = np.asarray(Y, dtype=np.float64)
        layer = GPRLayer(kern, mean_function or Zero(Y.shape[1]), Y.shape[1],
                         config=config)
        return cls(layer, Gaussian(noise_variance), X, Y)._finish(config,
                                                                  device)


class SGPR(_CollapsedSingleLayer):
    """Collapsed sparse GP regression (the Titsias bound) on an
    ``SGPRLayer`` with inducing inputs Z."""

    @classmethod
    def build(cls, X, Y, kern, Z, mean_function=None, noise_variance=1.0,
              config=Config(), device=None):
        X = np.asarray(X, dtype=np.float64)
        Y = np.asarray(Y, dtype=np.float64)
        layer = SGPRLayer(kern, Z, Y.shape[1],
                          mean_function or Zero(Y.shape[1]), config=config)
        return cls(layer, Gaussian(noise_variance), X, Y)._finish(config,
                                                                  device)


class GPRFITC(_SingleLayerGP):
    """FITC sparse GP regression (Snelson & Ghahramani): the exact
    marginal of N(m(X), Qff + diag(Kff - Qff) + sigma^2 I) by Woodbury.
    With G = diag(Kff - Qff + sigma^2) and A = L^-1 Kuf, the bound of a
    column is log N(y; m(X), A^T A + G), through B = I + (A / sqrt(g)) (A
    / sqrt(g))^T.  ``jitter`` (from ``config``) is Kuu's."""

    def __init__(self, kern, Z, mean_function, likelihood, X, Y,
                 jitter=1e-6):
        super().__init__(X, Y)
        self.kern = kern
        self.Z = Param(np.asarray(Z, dtype=np.float64))
        self.mean_function = mean_function
        # the likelihood last, as the JAX field order (``summary``'s rows)
        self.likelihood = likelihood
        self.jitter = float(jitter)

    @classmethod
    def build(cls, X, Y, kern, Z, mean_function=None, noise_variance=1.0,
              config=Config(), device=None):
        X = np.asarray(X, dtype=np.float64)
        Y = np.asarray(Y, dtype=np.float64)
        return cls(kern, Z, mean_function or Zero(Y.shape[1]),
                   Gaussian(noise_variance), X, Y,
                   jitter=config.jitter)._finish(config, device)

    def _common(self):
        X, Y = self.X_data, self.Y_data
        Z = self.Z.value
        M = Z.shape[0]
        sigma2 = self.likelihood.variance.value
        L = safe_cholesky(self.kern.K(Z), self.jitter)
        A = tri_solve(L, self.kern.K(Z, X), lower=True)          # (M, N)
        Qff = torch.sum(A ** 2, dim=0)                           # (N,)
        g = self.kern.Kdiag(X) - Qff + sigma2                    # (N,)
        sg = torch.sqrt(g)
        As = A / sg[None, :]
        B = As @ As.T + torch.eye(M, dtype=A.dtype, device=A.device)
        LB = cholesky_nan(B)
        err = Y - self.mean_function(X)                          # (N, D)
        c = tri_solve(LB, As @ (err / sg[:, None]), lower=True)  # (M, D)
        return dict(L=L, LB=LB, c=c, g=g, err=err)

    def log_likelihood(self, X=None, Y=None):
        cm = self._common()
        g, LB, c, err = cm["g"], cm["LB"], cm["c"], cm["err"]
        N, D = err.shape
        ll = -0.5 * N * D * math.log(2 * math.pi)
        ll = ll - 0.5 * D * torch.sum(torch.log(g))
        ll = ll - D * torch.sum(torch.log(torch.diagonal(LB)))
        ll = ll - 0.5 * torch.sum(err ** 2 / g[:, None])
        return ll + 0.5 * torch.sum(c ** 2)

    @torch.no_grad()
    def predict_f(self, Xnew, full_cov=False):
        cm = self._common()
        L, LB, c = cm["L"], cm["LB"], cm["c"]
        Xnew = self._as_input(Xnew)
        tmp1 = tri_solve(L, self.kern.K(self.Z.value, Xnew), lower=True)
        tmp2 = tri_solve(LB, tmp1, lower=True)
        mean = tmp2.T @ c + self.mean_function(Xnew)
        D = self.Y_data.shape[1]
        if full_cov:
            var = self.kern.K(Xnew) + tmp2.T @ tmp2 - tmp1.T @ tmp1
            return mean, var[:, :, None].expand(-1, -1, D)
        # the zero clamp of the collapsed layers' diagonal: float32
        # cancellation can leave the residual negative, and the cached
        # posterior clamps, so live and cached agree
        var = torch.clamp(self.kern.Kdiag(Xnew) + torch.sum(tmp2 ** 2, dim=0)
                          - torch.sum(tmp1 ** 2, dim=0), min=0.0)
        return mean, var[:, None].expand(-1, D)
