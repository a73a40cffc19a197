"""Mean functions: Zero, Identity, Linear, Constant.

Counterpart of ``doubly_stochastic_dgp_tpu/models/mean_functions.py``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..utils.params import Param

__all__ = ["Zero", "Identity", "Linear", "Constant"]


class Zero(nn.Module):
    def __init__(self, output_dim=1):
        super().__init__()
        self.output_dim = int(output_dim)

    def forward(self, X):
        return torch.zeros(*X.shape[:-1], self.output_dim, dtype=X.dtype,
                           device=X.device)


class Identity(nn.Module):
    def forward(self, X):
        return X


class Linear(nn.Module):
    """f(X) = X W + b.  W: (D_in, D_out); b: (D_out,)."""

    def __init__(self, W, b=None, trainable=True):
        super().__init__()
        W = torch.as_tensor(W, dtype=torch.float64)
        if b is None:
            b = torch.zeros(W.shape[1], dtype=torch.float64)
        self.W = Param(W, trainable=trainable)
        self.b = Param(b, trainable=trainable)

    def forward(self, X):
        return X @ self.W.value + self.b.value


class Constant(nn.Module):
    """f(X) = c, broadcast over X's rows.  c: (D_out,) (a scalar becomes
    (1,))."""

    def __init__(self, c, trainable=True):
        super().__init__()
        c = torch.as_tensor(c, dtype=torch.float64)
        self.c = Param(torch.atleast_1d(c), trainable=trainable)

    def forward(self, X):
        c = self.c.value
        return c.expand(*X.shape[:-1], c.shape[-1])
