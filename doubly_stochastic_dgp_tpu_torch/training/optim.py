"""The optimizer over a model's trainable parameters.

Counterpart of ``doubly_stochastic_dgp_tpu/training/optim.py::
masked_optimizer`` with ``optax.adam``.  The JAX package masks buffers and
frozen Params out of the update with ``trainable_mask``; here a frozen
``Param`` has ``requires_grad=False`` and data are buffers, so the
optimizer simply takes the parameters that require grad.

``torch.optim.Adam`` and ``optax.adam`` are the same formula with the same
defaults (b1 = 0.9, b2 = 0.999, eps = 1e-8 added to the bias-corrected
sqrt(v), no weight decay):

    m <- b1 m + (1 - b1) g,   v <- b2 v + (1 - b2) g^2,
    p <- p - lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps).

The two evaluate it in a different order, so their trajectories agree to
rounding; a 20-step trajectory test pins that in float64.
"""

from __future__ import annotations

import torch

__all__ = ["masked_optimizer"]


def masked_optimizer(model, learning_rate: float = 0.01):
    """Adam over the parameters of ``model`` that require grad."""
    params = [p for p in model.parameters() if p.requires_grad]
    return torch.optim.Adam(params, lr=learning_rate)
