"""Kernels of the main path: RBF (ARD), White and their Sum.

Counterpart of ``doubly_stochastic_dgp_tpu/ops/kernels.py``
(``Kernel``, ``Stationary``, ``RBF``, ``White``, ``Sum``).  On a CUDA
tensor ``RBF.K`` is the ``rbf_gram`` kernel (``ops/cuda/gram.py``), in
float32 and float64.  On the CPU the squared distance keeps the JAX form
||x||^2 + ||z||^2 - 2 x.z clipped at 0; its cross term is a plain
fp32/f64 matmul (the port never enables TF32, so it is as accurate as the
JAX HIGHEST-precision cross term).
"""

from __future__ import annotations

import torch
from torch import nn

from ..utils.params import Param
from .cuda.gram import rbf_gram, square_dist

__all__ = ["Kernel", "Stationary", "RBF", "White", "Sum"]


class Kernel(nn.Module):
    """Base kernel: subclasses implement K(X, X2) and Kdiag(X)."""

    def __init__(self, input_dim: int):
        super().__init__()
        self.input_dim = int(input_dim)

    def K(self, X, X2=None):
        raise NotImplementedError

    def Kdiag(self, X):
        raise NotImplementedError

    def __add__(self, other):
        return Sum([self, other])


class Stationary(Kernel):
    """Stationary kernel with ARD lengthscales and a variance."""

    def __init__(self, input_dim, variance=1.0, lengthscales=1.0, ard=True,
                 trainable=True):
        super().__init__(input_dim)
        ls = torch.as_tensor(lengthscales, dtype=torch.float64)
        if ard and ls.ndim == 0:
            ls = torch.full((self.input_dim,), float(ls),
                            dtype=torch.float64)
        self.variance = Param(variance, "positive", trainable)
        self.lengthscales = Param(ls, "positive", trainable)

    def scaled_square_dist(self, X, X2=None):
        ls = self.lengthscales.value
        return square_dist(X / ls, None if X2 is None else X2 / ls)

    @staticmethod
    def _shape_fn(r2):
        raise NotImplementedError

    def K(self, X, X2=None):
        return self.variance.value * self._shape_fn(
            self.scaled_square_dist(X, X2))

    def Kdiag(self, X):
        return torch.ones(X.shape[0], dtype=X.dtype,
                          device=X.device) * self.variance.value


class RBF(Stationary):
    @staticmethod
    def _shape_fn(r2):
        return torch.exp(-0.5 * r2)

    def K(self, X, X2=None):
        """On a CUDA tensor the ``rbf_gram`` kernel (``X2`` None as
        ``rbf_gram(X, X)``, so that autograd sums both operands'
        gradients); on the CPU the plain expression."""
        if X.device.type == "cuda":
            return rbf_gram(X, X if X2 is None else X2,
                            self.lengthscales.value, self.variance.value)
        return super().K(X, X2)


class White(Kernel):
    """White noise: K(X, X) = variance * I, zero cross-covariance."""

    def __init__(self, input_dim, variance=1.0, trainable=True):
        super().__init__(input_dim)
        self.variance = Param(variance, "positive", trainable)

    def K(self, X, X2=None):
        if X2 is None:
            return self.variance.value * torch.eye(
                X.shape[0], dtype=X.dtype, device=X.device)
        return torch.zeros(X.shape[0], X2.shape[0], dtype=X.dtype,
                           device=X.device)

    def Kdiag(self, X):
        return torch.ones(X.shape[0], dtype=X.dtype,
                          device=X.device) * self.variance.value


class Sum(Kernel):
    def __init__(self, kernels):
        kernels = list(kernels)
        super().__init__(kernels[0].input_dim)
        self.kernels = nn.ModuleList(kernels)

    def K(self, X, X2=None):
        return sum(k.K(X, X2) for k in self.kernels)

    def Kdiag(self, X):
        return sum(k.Kdiag(X) for k in self.kernels)
