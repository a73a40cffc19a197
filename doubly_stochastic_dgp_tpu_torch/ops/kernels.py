"""Kernels: RBF (ARD), the Matern family, rational quadratic, cosine,
periodic, arc-cosine, White, Constant, Linear and the Sum/Product algebra.

Counterpart of ``doubly_stochastic_dgp_tpu/ops/kernels.py`` (every
kernel it exports).  On a CUDA tensor ``RBF.K`` is the ``rbf_gram``
kernel (``ops/cuda/gram.py``), in float32 and float64, also as a factor
of a ``Sum`` or a ``Product``; every other kernel is plain PyTorch, as the
JAX package computes them in plain XLA.  The squared distance keeps the
JAX form ||x||^2 + ||z||^2 - 2 x.z clipped at 0; its cross term is a plain
fp32/f64 matmul (the port never enables TF32, so it is as accurate as the
JAX HIGHEST-precision cross term).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..utils.params import Param
from .cuda.gram import rbf_gram, square_dist

__all__ = [
    "Kernel", "Stationary", "RBF", "Matern12", "Matern32", "Matern52",
    "RationalQuadratic", "Cosine", "Periodic", "ArcCosine",
    "White", "Constant", "Linear", "Sum", "Product",
]


def _ard(value, input_dim, ard):
    """A float64 tensor of ``value``, a scalar broadcast to (input_dim,)
    when ``ard``."""
    v = torch.as_tensor(value, dtype=torch.float64)
    if ard and v.ndim == 0:
        v = torch.full((input_dim,), float(v), dtype=torch.float64)
    return v


def _ones(X):
    return torch.ones(X.shape[0], dtype=X.dtype, device=X.device)


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

    def __mul__(self, other):
        return Product([self, other])


class Stationary(Kernel):
    """Stationary kernel with ARD lengthscales and a variance."""

    def __init__(self, input_dim, variance=1.0, lengthscales=1.0, ard=True,
                 trainable=True):
        super().__init__(input_dim)
        self.variance = Param(variance, "positive", trainable)
        self.lengthscales = Param(_ard(lengthscales, self.input_dim, ard),
                                  "positive", trainable)

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
        return _ones(X) * self.variance.value


def _safe_r(r2):
    """sqrt with the JAX gradient-safe floor: r2 below 1e-36 (a clipped
    0) gives r = 1e-18 and a zero gradient."""
    return torch.sqrt(torch.clamp(r2, min=1e-36))


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


class Matern12(Stationary):
    @staticmethod
    def _shape_fn(r2):
        return torch.exp(-_safe_r(r2))


class Matern32(Stationary):
    @staticmethod
    def _shape_fn(r2):
        r = _safe_r(r2)
        s3 = math.sqrt(3.0)
        return (1.0 + s3 * r) * torch.exp(-s3 * r)


class Matern52(Stationary):
    @staticmethod
    def _shape_fn(r2):
        r = _safe_r(r2)
        s5 = math.sqrt(5.0)
        return (1.0 + s5 * r + 5.0 / 3.0 * r2) * torch.exp(-s5 * r)


class RationalQuadratic(Stationary):
    """k(r^2) = variance (1 + r^2 / (2 alpha))^(-alpha), with a trainable
    alpha."""

    def __init__(self, input_dim, variance=1.0, lengthscales=1.0, alpha=1.0,
                 ard=True, trainable=True):
        super().__init__(input_dim, variance, lengthscales, ard, trainable)
        self.alpha = Param(alpha, "positive", trainable)

    def K(self, X, X2=None):
        r2 = self.scaled_square_dist(X, X2)
        a = self.alpha.value
        return self.variance.value * (1.0 + r2 / (2.0 * a)) ** (-a)


class Cosine(Stationary):
    """k(r) = variance cos(r) of the scaled Euclidean distance."""

    @staticmethod
    def _shape_fn(r2):
        return torch.cos(_safe_r(r2))


class Periodic(Kernel):
    """Exp-sine-squared periodic kernel: variance exp(-0.5 sum_d
    sin^2(pi (x_d - z_d) / period) / ls_d^2), from the (N, M, D)
    differences (no matmul form through the sine)."""

    def __init__(self, input_dim, variance=1.0, lengthscales=1.0, period=1.0,
                 ard=True, trainable=True):
        super().__init__(input_dim)
        self.variance = Param(variance, "positive", trainable)
        self.lengthscales = Param(_ard(lengthscales, self.input_dim, ard),
                                  "positive", trainable)
        self.period = Param(period, "positive", trainable)

    def K(self, X, X2=None):
        X2 = X if X2 is None else X2
        d = X[:, None, :] - X2[None, :, :]                       # (N, M, D)
        s = torch.sin(math.pi * d / self.period.value) \
            / self.lengthscales.value
        return self.variance.value * torch.exp(
            -0.5 * torch.sum(s ** 2, dim=-1))

    def Kdiag(self, X):
        return _ones(X) * self.variance.value


class ArcCosine(Kernel):
    """Cho and Saul's arc-cosine kernel of order 0, 1 or 2, with ARD
    weight variances and a bias variance."""

    def __init__(self, input_dim, order=1, variance=1.0,
                 weight_variances=1.0, bias_variance=1.0, ard=True,
                 trainable=True):
        super().__init__(input_dim)
        if order not in (0, 1, 2):
            raise ValueError("arc-cosine order must be 0, 1 or 2")
        self.order = int(order)
        self.variance = Param(variance, "positive", trainable)
        self.weight_variances = Param(
            _ard(weight_variances, self.input_dim, ard), "positive",
            trainable)
        self.bias_variance = Param(bias_variance, "positive", trainable)

    def _J(self, theta):
        if self.order == 0:
            return math.pi - theta
        if self.order == 1:
            return torch.sin(theta) + (math.pi - theta) * torch.cos(theta)
        return 3.0 * torch.sin(theta) * torch.cos(theta) \
            + (math.pi - theta) * (1.0 + 2.0 * torch.cos(theta) ** 2)

    def K(self, X, X2=None):
        w = self.weight_variances.value
        b = self.bias_variance.value
        dX = b + torch.sum(X ** 2 * w, dim=-1)
        num = b + (X * w) @ (X if X2 is None else X2).T
        dX2 = dX if X2 is None else b + torch.sum(X2 ** 2 * w, dim=-1)
        denom = torch.sqrt(dX[:, None] * dX2[None, :])
        # clipped before arccos: rounding can put num / denom past +-1
        theta = torch.arccos(torch.clamp(num / denom, -1.0, 1.0))
        return (self.variance.value * (1.0 / math.pi)
                * self._J(theta) * denom ** self.order)

    def Kdiag(self, X):
        d = self.bias_variance.value + torch.sum(
            X ** 2 * self.weight_variances.value, dim=-1)
        return self.variance.value / math.pi * self._J(
            torch.zeros_like(d)) * d ** self.order


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
        return _ones(X) * self.variance.value


class Constant(Kernel):
    def __init__(self, input_dim, variance=1.0, trainable=True):
        super().__init__(input_dim)
        self.variance = Param(variance, "positive", trainable)

    def K(self, X, X2=None):
        M = X.shape[0] if X2 is None else X2.shape[0]
        return self.variance.value * torch.ones(
            X.shape[0], M, dtype=X.dtype, device=X.device)

    def Kdiag(self, X):
        return _ones(X) * self.variance.value


class Linear(Kernel):
    """k(x, z) = sum_d variance_d x_d z_d: one variance by default, one a
    dimension with ``ard``."""

    def __init__(self, input_dim, variance=1.0, ard=False, trainable=True):
        super().__init__(input_dim)
        self.variance = Param(_ard(variance, self.input_dim, ard),
                              "positive", trainable)

    def K(self, X, X2=None):
        return (X * self.variance.value) @ (X if X2 is None else X2).T

    def Kdiag(self, X):
        return torch.sum(X ** 2 * self.variance.value, dim=-1)


class Sum(Kernel):
    def __init__(self, kernels):
        kernels = list(kernels)
        super().__init__(kernels[0].input_dim)
        self.kernels = nn.ModuleList(kernels)

    def K(self, X, X2=None):
        return sum(k.K(X, X2) for k in self.kernels)

    def Kdiag(self, X):
        return sum(k.Kdiag(X) for k in self.kernels)


class Product(Kernel):
    def __init__(self, kernels):
        kernels = list(kernels)
        super().__init__(kernels[0].input_dim)
        self.kernels = nn.ModuleList(kernels)

    def K(self, X, X2=None):
        out = self.kernels[0].K(X, X2)
        for k in self.kernels[1:]:
            out = out * k.K(X, X2)
        return out

    def Kdiag(self, X):
        out = self.kernels[0].Kdiag(X)
        for k in self.kernels[1:]:
            out = out * k.Kdiag(X)
        return out
