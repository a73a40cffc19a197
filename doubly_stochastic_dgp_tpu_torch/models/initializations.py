"""Layer-stack construction: identity/PCA skip connections and input
propagation.

Counterpart of ``doubly_stochastic_dgp_tpu/models/initializations.py``.
``init_layers_linear``: dim-matched inner layers get an Identity mean
function, narrowing layers a frozen PCA projection, widening layers a
frozen identity-plus-zero padding, and the running inputs and inducing
points are pushed through each projection.  ``init_layers_input_prop``:
every layer after the first sees the D data columns beside the previous
layer's samples, and its inducing inputs are padded with seeded noise in
the hidden columns.  Host-side numpy in float64.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import Config
from .layers import SVGPLayer
from .mean_functions import Identity, Linear, Zero

__all__ = ["init_layers_linear", "init_layers_input_prop"]


def _linear_projection(dim_in, dim_out, running_inputs):
    """(dim_in, dim_out) projection: top principal directions when
    narrowing, identity padded with zeros when widening."""
    if dim_in > dim_out:
        _, _, vt = np.linalg.svd(running_inputs, full_matrices=False)
        return np.ascontiguousarray(vt[:dim_out].T)
    return np.pad(np.eye(dim_in), ((0, 0), (0, dim_out - dim_in)))


def init_layers_linear(X, Y, Z, kernels, num_outputs=None,
                       mean_function=None, white=False, config=Config()):
    """The paper's SVGP stack: layer l maps kernels[l].input_dim to
    kernels[l+1].input_dim (the last layer to ``num_outputs`` with the
    given mean function)."""
    X = np.asarray(X, dtype=np.float64)
    Y = np.asarray(Y)
    num_outputs = num_outputs or Y.shape[1]
    if mean_function is None:
        mean_function = Zero(num_outputs)

    widths_in = [k.input_dim for k in kernels]
    widths_out = widths_in[1:] + [num_outputs]

    inputs_running = X.copy()
    inducing_running = np.asarray(Z, dtype=np.float64).copy()
    layers = []
    for l, kern in enumerate(kernels):
        last = l == len(kernels) - 1
        d_in, d_out = widths_in[l], widths_out[l]
        project = None
        if last:
            mf = mean_function
        elif d_in == d_out:
            mf = Identity()
        else:
            project = _linear_projection(d_in, d_out, inputs_running)
            mf = Linear(project, trainable=False)
        layers.append(SVGPLayer(kern, inducing_running, d_out, mf,
                                white=white, config=config))
        if project is not None:
            inputs_running = inputs_running @ project
            inducing_running = inducing_running @ project
    return layers


def _noise_padded_inducing(Z, target_width, kern_std, rng):
    """Z padded to ``target_width`` columns with draws from ``rng`` scaled
    by twice the kernel amplitude (the extra columns live in the sampled
    outputs' space, whose scale the kernel sets)."""
    extra = target_width - Z.shape[1]
    if extra == 0:
        return Z
    noise = rng.randn(Z.shape[0], extra) * (2.0 * kern_std)
    return np.concatenate([Z, noise], axis=1)


def init_layers_input_prop(X, Y, Z, kernels, num_outputs=None,
                           mean_function=None, white=False,
                           rng: Optional[np.random.RandomState] = None,
                           config=Config()):
    """The input-propagation stack: layer l takes width D + hidden_{l-1}
    (its kernel's input_dim), the inner layers propagate their D input
    columns and have Zero mean functions, and each layer's inducing
    inputs are Z padded with noise from ``rng`` (default
    ``RandomState(0)``, as the JAX package, so both draw the same Z)."""
    X = np.asarray(X, dtype=np.float64)
    Y = np.asarray(Y)
    Z = np.asarray(Z, dtype=np.float64)
    num_outputs = num_outputs or Y.shape[1]
    if mean_function is None:
        mean_function = Zero(num_outputs)
    rng = rng or np.random.RandomState(0)
    D = X.shape[1]

    def amplitude(kern):
        return float(kern.variance.value.detach()) ** 0.5

    layers = []
    for l, kern in enumerate(kernels):
        last = l == len(kernels) - 1
        width = kern.input_dim
        if last:
            d_out, mf, prop = num_outputs, mean_function, None
            # the hidden columns' scale comes from the previous kernel
            std = amplitude(kernels[l - 1]) if width > D else 1.0
        else:
            d_out = kernels[l + 1].input_dim - D
            mf, prop = Zero(d_out), D
            std = amplitude(kern)
        Zl = _noise_padded_inducing(Z, width, std, rng)
        layers.append(SVGPLayer(kern, Zl, d_out, mf, white=white,
                                input_prop_dim=prop, config=config))
    return layers
