"""DGPDamianou: the fully collapsed deep GP of Damianou & Lawrence
(AISTATS 2013), with the uncertainty of every hidden layer carried by psi
statistics instead of Monte-Carlo samples.

Counterpart of ``doubly_stochastic_dgp_tpu/models/damianou.py``.  The
generative model is H_0 = X, H_l = f_l(H_{l-1}) + eps_l with eps_l ~ N(0,
sigma_l^2 I) and Y = H_L; the variational posterior is q(H_l) = N(m_l,
diag(s_l)) per hidden layer, with each layer's inducing outputs collapsed
(Titsias).  The bound is the sum over layers of the uncertain-input SGPR
bound g_l, in expectation over the layer's random outputs, plus the
entropies of the q(H_l).  g_l is quadratic in its targets, so

    E_{Y ~ N(m, diag(s))}[g_l(Y)] = g_l(m) - sum s / (2 sigma^2)
                                    + (1/2) sum_{n,d} [G^T G]_nn s_nd,

with G = LB^-1 A / sigma, the linear map from the targets to c in the
bound.  The bound is evaluated on the whole training set.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..config import Config, resolve_device
from ..graphs import randn
from ..ops.likelihoods import Gaussian
from ..ops.linalg import reparameterize, tri_solve
from ..utils.params import Param
from .dgp import DGPBase
from .initializations import _linear_projection
from .layers import SGPRLayer
from .mean_functions import Zero

__all__ = ["DGPDamianou"]


class DGPDamianou(DGPBase):
    """A stack of collapsed ``SGPRLayer``s with explicit q(H_l):
    ``h_mean[l]`` (N, D_{l+1}) and ``h_var[l]`` (N, D_{l+1}, positive) of
    hidden layer l+1, and ``noise[l]`` (positive), its noise variance
    sigma_{l+1}^2.  The top layer's noise is the likelihood's variance."""

    full_batch_bound = True     # q(H) has one row per training point

    def __init__(self, likelihood, layers, X, Y, h_mean, h_var, noise,
                 num_samples=1, num_data=None):
        super().__init__(likelihood, layers, X, Y, num_samples=num_samples,
                         num_data=num_data)
        self.h_mean = nn.ModuleList(Param(m) for m in h_mean)
        self.h_var = nn.ModuleList(Param(v, "positive") for v in h_var)
        self.noise = nn.ModuleList(Param(n, "positive") for n in noise)

    @classmethod
    def build(cls, X, Y, Z, kernels, likelihood, inner_noise=1e-2,
              h_var_init=1e-2, num_samples=1, num_data=None,
              mean_function=None, config=Config(), device=None):
        """The hidden width of layer l is ``kernels[l+1].input_dim``;
        hidden means start at the running PCA/identity projections of X
        (the ``init_layers_linear`` convention), inducing inputs at the
        projected Z, hidden variances at ``h_var_init``.  Built on the
        host in float64, then moved to ``device`` (CUDA unless given) in
        ``config.dtype``."""
        if not isinstance(likelihood, Gaussian):
            raise ValueError("DGPDamianou collapses Gaussian layer "
                             "conditionals; the likelihood must be Gaussian")
        device = resolve_device(device)
        X = np.asarray(X, dtype=np.float64)
        Y = np.asarray(Y, dtype=np.float64)
        Z = np.asarray(Z, dtype=np.float64)
        num_outputs = Y.shape[1]
        widths_in = [k.input_dim for k in kernels]
        widths_out = widths_in[1:] + [num_outputs]

        layers, h_mean, h_var, noise = [], [], [], []
        inputs_running, inducing_running = X.copy(), Z.copy()
        for l, kern in enumerate(kernels):
            last = l == len(kernels) - 1
            d_in, d_out = widths_in[l], widths_out[l]
            mf = ((mean_function or Zero(num_outputs)) if last
                  else Zero(d_out))
            layers.append(SGPRLayer(kern, inducing_running, d_out, mf,
                                    config=config))
            if not last:
                if d_in != d_out:
                    W = _linear_projection(d_in, d_out, inputs_running)
                    inputs_running = inputs_running @ W
                    inducing_running = inducing_running @ W
                h_mean.append(inputs_running.copy())
                h_var.append(np.full_like(inputs_running, h_var_init))
                noise.append(np.asarray(inner_noise, dtype=np.float64))
        model = cls(likelihood, layers, X, Y, h_mean, h_var, noise,
                    num_samples=num_samples, num_data=num_data)
        return model.to(device=device, dtype=config.dtype)

    def _layer_data(self, l):
        """(X_mean, X_var, targets, noise variance) of layer ``l`` under
        q; X_var is None for the first layer (observed inputs: the
        certain-input branch of the bound)."""
        last = l == len(self.layers) - 1
        mu = self.X_data if l == 0 else self.h_mean[l - 1].value
        sv = None if l == 0 else self.h_var[l - 1].value
        Yl = self.Y_data if last else self.h_mean[l].value
        var_l = (self.likelihood.variance.value if last
                 else self.noise[l].value)
        return mu, sv, Yl, var_l

    def _data_layers(self):
        return [layer.set_data(*self._layer_data(l))
                for l, layer in enumerate(self.layers)]

    def elbo(self, X=None, Y=None, generator=None, zs=None):
        """The Damianou-Lawrence bound, always on the whole stored
        training set (``X``, ``Y``, ``generator`` and ``zs`` are
        ignored: the bound has no random draws)."""
        total = 0.0
        L = len(self.layers)
        for l, lay in enumerate(self._data_layers()):
            cm = lay._common()
            g = lay.build_likelihood(cm=cm)
            if l < L - 1:
                # E over the layer's random outputs H_{l+1} ~ q, with the
                # bound's own (floored) variance
                s = self.h_var[l].value                          # (N, d)
                var_l = lay._bound_variance()
                G = tri_solve(cm["LB"], cm["A"], lower=True,
                              mode=lay.solve_mode) / torch.sqrt(var_l)
                diagGtG = torch.sum(G ** 2, dim=0)               # (N,)
                g = (g - 0.5 * torch.sum(s) / var_l
                     + 0.5 * torch.sum(diagGtG[:, None] * s))
                # + the entropy of q(H_{l+1})
                g = g + 0.5 * torch.sum(torch.log(2.0 * math.pi * math.e
                                                  * s))
            total = total + g
        return total

    def propagate(self, X, generator=None, S=1, zs=None, full_cov=False):
        """Sample new points through the layers' collapsed posteriors.
        Inner layers add their noise variance sigma_l^2 (the next layer
        consumes H_l = f_l + eps_l; with ``full_cov`` on the diagonal of
        each (N, N) block); the top layer returns the noiseless f
        posterior (``predict_y`` adds the likelihood's variance)."""
        layers = self._data_layers()
        L = len(layers)
        X = self._as_input(X)
        F = X[None].expand(S, *X.shape)
        if zs is None:
            zs = [None] * L
        Fs, Fmeans, Fvars = [], [], []
        for l, (layer, z) in enumerate(zip(layers, zs)):
            mean, var = layer.conditional_SND(F, full_cov=full_cov)
            if l < L - 1:
                noise = self.noise[l].value
                if full_cov:                    # (S, N, N, D) diagonal
                    N = var.shape[1]
                    noise = noise * torch.eye(N, dtype=var.dtype,
                                              device=var.device)[None, :, :,
                                                                 None]
                var = var + noise
            if z is None:
                if generator is None:
                    raise ValueError("need a generator when z is not given")
                z = randn(mean.shape, generator, mean.dtype, mean.device)
            else:
                z = torch.as_tensor(z, dtype=mean.dtype,
                                    device=mean.device).expand(mean.shape)
            F = reparameterize(mean, var, z, layer.jitter, full_cov=full_cov)
            Fs.append(F)
            Fmeans.append(mean)
            Fvars.append(var)
        return Fs, Fmeans, Fvars
