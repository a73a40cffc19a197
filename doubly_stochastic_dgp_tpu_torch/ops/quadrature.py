"""Gauss-Hermite quadrature.

Counterpart of ``doubly_stochastic_dgp_tpu/ops/quadrature.py``
(``hermgauss``, ``mvhermgauss``, ``ndiagquad``).  The nodes and weights
are computed on the host with numpy, as in the JAX package; ``ndiagquad``
holds them as tensors on the integrand's device and dtype, made once per
(H, dtype, device) outside any CUDA graph capture (a capture's eager
warm-up makes them), so a captured call copies nothing from the host.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

__all__ = ["hermgauss", "mvhermgauss", "ndiagquad", "gh_tensors"]


def hermgauss(H: int):
    """1D Gauss-Hermite nodes and weights (physicists', weight
    exp(-x^2)), float64 numpy arrays."""
    x, w = np.polynomial.hermite.hermgauss(H)
    return x.astype(np.float64), w.astype(np.float64)


def mvhermgauss(H: int, D: int):
    """Multivariate Gauss-Hermite grid, the cartesian product of 1D rules:
    x (H**D, D) locations and w (H**D,) weights for integrals against
    exp(-||x||^2)."""
    gh_x, gh_w = hermgauss(H)
    x = np.array(list(itertools.product(*(gh_x,) * D)))
    w = np.prod(np.array(list(itertools.product(*(gh_w,) * D))), 1)
    return x, w


@functools.lru_cache(maxsize=32)
def gh_tensors(H: int, dtype: torch.dtype, device: torch.device):
    """(x, w / sqrt(pi)) of :func:`hermgauss` as (H,) tensors; made once
    per (H, dtype, device) and shared, read-only."""
    x, w = hermgauss(H)
    return (torch.as_tensor(x, dtype=dtype, device=device),
            torch.as_tensor(w / np.sqrt(np.pi), dtype=dtype, device=device))


def ndiagquad(funcs, H: int, Fmu, Fvar, logspace: bool = False, **Ys):
    """Quadrature of func(F, **Ys) against independent Gaussians N(Fmu,
    Fvar), elementwise.

    ``funcs``: a callable or a list of callables taking (X, **Ys)
    elementwise; ``Fmu``, ``Fvar`` of one shape; ``logspace`` returns
    log E[exp(func)] by a logsumexp (predictive densities)."""
    x, w = gh_tensors(H, Fmu.dtype, Fmu.device)
    shape = (H,) + (1,) * Fmu.ndim
    xn, wn = x.reshape(shape), w.reshape(shape)
    # floor: d sqrt(v)/dv is infinite at v = 0, and the conditional
    # variance is clamped at exactly 0 upstream; clamp_min has zero
    # gradient below the floor, so gradients stay finite
    Fvar = torch.clamp_min(Fvar, 1e-12)
    X = Fmu[None] + torch.sqrt(2.0 * Fvar)[None] * xn          # (H, ...)

    def one(f):
        fX = f(X, **Ys)
        if logspace:
            return torch.logsumexp(fX + torch.log(wn), dim=0)
        return torch.sum(fX * wn, dim=0)

    if isinstance(funcs, (list, tuple)):
        return [one(f) for f in funcs]
    return one(funcs)
