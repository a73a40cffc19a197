"""DGP with an analytically collapsed final layer.

Counterpart of ``DGPCollapsed`` in ``doubly_stochastic_dgp_tpu/models/
zoo.py``: the inner SVGP layers propagate the *training* inputs (S = 1),
and the last inner layer's mean and variance are the Gaussian inputs of
the collapsed SGPR layer, whose uncertain-input Titsias bound (psi
statistics) is the objective, less the inner layers' KL terms.
``DGPHeinonen`` and ``DGPHeteroscedastic`` are not ported yet (ROADMAP).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Config, resolve_device
from .dgp import DGPBase
from .initializations import init_layers_linear
from .layers import SGPRLayer

__all__ = ["DGPCollapsed"]


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
        model = cls(likelihood, layers, X, Y, num_samples=num_samples,
                    num_data=num_data, remat=config.remat)
        return model.to(device=device, dtype=config.dtype)

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
