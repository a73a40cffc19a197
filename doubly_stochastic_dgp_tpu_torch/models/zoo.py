"""The DGP with an analytically collapsed final layer and the
heteroscedastic-noise DGP.

Counterpart of ``DGPCollapsed`` and ``DGPHeteroscedastic`` in
``doubly_stochastic_dgp_tpu/models/zoo.py``.  ``DGPCollapsed``: the inner
SVGP layers propagate the *training* inputs (S = 1), and the last inner
layer's mean and variance are the Gaussian inputs of the collapsed SGPR
layer, whose uncertain-input Titsias bound (psi statistics) is the
objective, less the inner layers' KL terms.  ``DGPHeteroscedastic``: the
final layer has a mean head and a log-noise head for each target, and
the noise head's expectation is taken by Gauss-Hermite quadrature.
``DGPHeinonen``: the dense 2-layer model for MCMC, a ``GPMCLayer`` whose
deterministic latents at the training inputs feed an exact ``GPRLayer``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import Config, resolve_device
from ..ops.likelihoods import Gaussian
from ..ops.quadrature import ndiagquad
from ..utils.params import log_prior
from .dgp import DGP, DGPBase
from .initializations import init_layers_linear
from .layers import GPMCLayer, GPRLayer, SGPRLayer

__all__ = ["DGPCollapsed", "DGPHeinonen", "DGPHeteroscedastic"]


class DGPCollapsed(DGPBase):
    """SVGP inner layers and a collapsed ``SGPRLayer`` on top."""

    full_batch_bound = True     # the bound uses the whole stored data set

    @classmethod
    def build(cls, X, Y, Z, kernels, likelihood, mean_function=None,
              num_samples=1, num_data=None, config=Config(), device=None):
        """The identity/PCA-initialized SVGP stack of ``init_layers_linear``
        with its last layer replaced by an ``SGPRLayer`` on the same
        kernel, inducing inputs and mean function (the JAX bench's
        ``build_collapsed``).  Built on the host in float64, then moved to
        ``device`` (CUDA unless given) in ``config.dtype``."""
        device = resolve_device(device)
        X = np.asarray(X, dtype=np.float64)
        Y = np.asarray(Y, dtype=np.float64)
        num_outputs = Y.shape[1]
        layers = init_layers_linear(X, Y, Z, kernels,
                                    num_outputs=num_outputs,
                                    mean_function=mean_function,
                                    config=config)
        top = layers[-1]
        layers[-1] = SGPRLayer(top.kern, top.Z.value.detach().numpy(),
                               num_outputs, top.mean_function, config=config)
        return cls.make(X, Y, likelihood, layers, num_samples=num_samples,
                        num_data=num_data, config=config, device=device)

    def inner_layers_propagate(self, X, generator=None, S=1, zs=None,
                               full_cov=False):
        """Propagate through ``layers[:-1]``; with a single layer, the
        identity with zero variance."""
        if len(self.layers) == 1:
            sX = self._as_input(X)[None].expand(S, *X.shape)
            return [sX], [sX], [torch.zeros_like(sX)]
        return self._propagate_layers(self.layers[:-1], X, generator, S, zs,
                                      full_cov)

    def _collapsed_last_layer(self, generator=None, zs=None):
        """The collapsed layer carrying the inner propagation of the
        training inputs as its Gaussian inputs."""
        generator = self._default_generator(generator, zs)
        _, ms, vs = self.inner_layers_propagate(self.X_data, generator,
                                                zs=zs)
        return self.layers[-1].set_data(ms[-1][0], vs[-1][0], self.Y_data,
                                        self.likelihood.variance.value)

    def propagate(self, X, generator=None, S=1, zs=None, full_cov=False):
        """As ``DGPBase.propagate``, through the collapsed layer (whose
        inputs, the training rows' propagation, are always diagonal).
        ``zs`` serves both the training-data propagation and this one, as
        in the JAX package, so it must broadcast over both row counts."""
        last = self._collapsed_last_layer(generator, zs)
        return self._propagate_layers(list(self.layers[:-1]) + [last], X,
                                      generator, S, zs, full_cov)

    def elbo(self, X=None, Y=None, generator=None, zs=None):
        """The collapsed bound less the inner layers' KL terms, always on
        the whole stored training set (``X`` and ``Y`` are ignored)."""
        last = self._collapsed_last_layer(generator, zs)
        KL = sum(layer.KL() for layer in self.layers[:-1])
        return last.build_likelihood() - KL


class DGPHeinonen(DGPCollapsed):
    """Dense 2-layer non-stationary GP (Heinonen et al. 2016) for MCMC: the
    inner propagation is the ``GPMCLayer``'s deterministic
    ``build_latents``, the final layer exact GPR on them.  Gaussian
    likelihood, no minibatching."""

    @classmethod
    def make(cls, X, Y, likelihood, layers, **kwargs):
        assert len(layers) == 2
        assert isinstance(likelihood, Gaussian)
        assert isinstance(layers[0], GPMCLayer)
        assert isinstance(layers[1], GPRLayer)
        return super().make(X, Y, likelihood, layers, **kwargs)

    def inner_layers_propagate(self, X, generator=None, S=1, zs=None,
                               full_cov=False):
        f = self.layers[0].build_latents()[None]
        return [f], [f], [torch.zeros_like(f)]

    def _collapsed_last_layer(self, generator=None, zs=None):
        """The GPR layer on the latents at the training inputs; their
        propagation draws nothing, so no generator is made (a capture
        could not make one)."""
        f = self.layers[0].build_latents()
        return self.layers[-1].set_data(f, torch.zeros_like(f), self.Y_data,
                                        self.likelihood.variance.value)

    def log_posterior(self, generator=None):
        """The MCMC target: the exact marginal likelihood on the latents
        plus the parameters' priors (the q_mu unit Gaussians)."""
        return self.elbo(generator=generator) + log_prior(self.layers)


def _softplus(G):
    """log(1 + e^G) as logaddexp(G, 0), the ``jax.nn.softplus`` formula
    (``torch.nn.functional.softplus`` returns G itself above 20, about
    2e-9 relative off it)."""
    return torch.logaddexp(G, torch.zeros_like(G))


class DGPHeteroscedastic(DGP):
    """Heteroscedastic-noise DGP: the final layer emits 2 D_Y outputs,
    (mean, log-noise) heads; the likelihood is a per-point Gaussian whose
    variance is softplus(g) + ``min_noise``.  The likelihood object's
    own variance is not used.

    ``predict_f`` returns the raw heads, (S, N, 2 D): columns [:D] the
    mean head f, [D:] the noise head g before the softplus;
    ``predict_y`` and ``predict_density`` are in y-space.  ``min_noise``
    (1e-4, as the JAX package) floors the noise variance: with a lower
    floor a spike in the noise head's variance makes the quadrature probe
    g where the noise is at the floor, and the gradients blow up."""

    def __init__(self, likelihood, layers, X, Y, num_samples=1,
                 num_data=None, remat=False, min_noise=1e-4):
        super().__init__(likelihood, layers, X, Y, num_samples=num_samples,
                         num_data=num_data, remat=remat)
        self.min_noise = float(min_noise)

    @classmethod
    def build(cls, X, Y, Z, kernels, likelihood, num_outputs=None, **kw):
        """``DGP.build`` with 2 D_Y outputs by default."""
        num_outputs = num_outputs or 2 * np.asarray(Y).shape[1]
        return super().build(X, Y, Z, kernels, likelihood,
                             num_outputs=num_outputs, **kw)

    def _noise(self, G):
        return _softplus(G) + self.min_noise

    def E_log_p_Y(self, X, Y, generator=None, zs=None):
        """E_{f,g}[log N(y; f, noise(g))], averaged over the samples: the
        f-expectation in closed form given g, the g-expectation by
        20-point Gauss-Hermite quadrature.  (N, D)."""
        Fmean, Fvar = self._predict(X, generator=generator,
                                    S=self.num_samples, zs=zs)
        Y = self._as_input(Y)
        D = Y.shape[-1]
        m_f, m_g = Fmean[..., :D], Fmean[..., D:]
        v_f, v_g = Fvar[..., :D], Fvar[..., D:]

        def integrand(G, Y):
            noise = self._noise(G)
            return (-0.5 * torch.log(2 * math.pi * noise)
                    - 0.5 * ((Y - m_f) ** 2 + v_f) / noise)

        var_exp = ndiagquad(integrand, 20, m_g, v_g, Y=Y)
        return torch.mean(var_exp, dim=0)

    def sample_predict_y(self, Fmean, Fvar):
        """Per-sample y moments: mean m_f, variance v_f + E[noise(g)] over
        q(g) = N(m_g, v_g) by Gauss-Hermite quadrature."""
        D = Fmean.shape[-1] // 2
        m_f, m_g = Fmean[..., :D], Fmean[..., D:]
        v_f, v_g = Fvar[..., :D], Fvar[..., D:]
        return m_f, v_f + ndiagquad(self._noise, 20, m_g, v_g)

    def sample_log_densities(self, Fmean, Fvar, Ynew):
        """Per-sample log predictive density, (S, N, D): N(y; m_f, v_f +
        noise(g)) integrated over g by Gauss-Hermite quadrature in log
        space."""
        D = Ynew.shape[-1]
        m_f, m_g = Fmean[..., :D], Fmean[..., D:]
        v_f, v_g = Fvar[..., :D], Fvar[..., D:]

        def log_gauss(G, Y):
            var = v_f + self._noise(G)
            return -0.5 * (torch.log(2 * math.pi * var) + (Y - m_f) ** 2
                           / var)

        return ndiagquad(log_gauss, 20, m_g, v_g, logspace=True, Y=Ynew)
