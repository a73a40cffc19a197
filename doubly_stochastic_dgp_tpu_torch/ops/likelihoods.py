"""Gaussian likelihood: log density, variational expectations and the
prediction surface.

Counterpart of ``doubly_stochastic_dgp_tpu/ops/likelihoods.py::
Gaussian``.  Every method broadcasts over leading sample dims, so (S, N,
D) moments against (N, D) targets work as in the JAX package.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..utils.params import Param

__all__ = ["Gaussian"]


class Gaussian(nn.Module):
    def __init__(self, variance=1.0, trainable=True):
        super().__init__()
        self.variance = Param(variance, "positive", trainable)

    def logp(self, F, Y):
        v = self.variance.value
        return -0.5 * torch.log(2 * math.pi * v) - 0.5 * (Y - F) ** 2 / v

    def variational_expectations(self, Fmu, Fvar, Y):
        """E_{N(f; Fmu, Fvar)}[log p(Y | f)], elementwise, in closed form."""
        v = self.variance.value
        return (-0.5 * math.log(2 * math.pi) - 0.5 * torch.log(v)
                - 0.5 * ((Y - Fmu) ** 2 + Fvar) / v)

    def predict_mean_and_var(self, Fmu, Fvar):
        return Fmu, Fvar + self.variance.value

    def predict_density(self, Fmu, Fvar, Y):
        v = Fvar + self.variance.value
        return -0.5 * torch.log(2 * math.pi * v) - 0.5 * (Y - Fmu) ** 2 / v
