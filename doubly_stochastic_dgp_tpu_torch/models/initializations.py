"""Layer-stack construction with identity/PCA skip connections.

Counterpart of ``doubly_stochastic_dgp_tpu/models/initializations.py::
init_layers_linear``: dim-matched inner layers get an Identity mean
function, narrowing layers a frozen PCA projection, widening layers a
frozen identity-plus-zero padding, and the running inputs and inducing
points are pushed through each projection.  Host-side numpy in float64.
"""

from __future__ import annotations

import numpy as np

from ..config import Config
from .layers import SVGPLayer
from .mean_functions import Identity, Linear, Zero

__all__ = ["init_layers_linear"]


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
