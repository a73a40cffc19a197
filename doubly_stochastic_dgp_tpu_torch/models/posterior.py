"""Precomputed-posterior (serving) cache for SVGP layers.

Counterpart of ``doubly_stochastic_dgp_tpu/models/posterior.py``
(``CachedSVGPLayer``, ``_cache_svgp`` and the Monte-Carlo family branch
of ``precompute``).  At serving time the parameters are frozen, so the
staging factors

    Li = Lu^{-1},  alpha = Li q_mu (q_mu if white),  C = Li q_sqrt (q_sqrt)

are computed once, and a prediction needs only the grams and matmuls:
G = Li Kuf, mean = G^T alpha + m(X), var = Kff - colsum(G*G) +
colsum(H*H) with H = C^T G — the same sum-of-squares form as the live
``solve_mode='inverse'`` branch — or, with ``full_cov``, K(X) - G^T G +
H^T H per output.  A cached layer keeps its live layer's
``input_prop_dim``.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from ..ops.linalg import inv_lower
from .dgp import DGPBase
from .layers import Layer, SVGPLayer

__all__ = ["CachedSVGPLayer", "precompute"]


class CachedSVGPLayer(Layer):
    """Prediction-only SVGP layer holding the staging factors as buffers."""

    def __init__(self, kern, Z, Li, alpha, C, mean_function, num_outputs,
                 jitter, input_prop_dim=None):
        super().__init__()
        self.kern = kern
        self.mean_function = mean_function
        self.register_buffer("Z", Z)
        self.register_buffer("Li", Li)
        self.register_buffer("alpha", alpha)
        self.register_buffer("C", C)
        self.num_outputs_ = int(num_outputs)
        self.jitter = float(jitter)
        self.input_prop_dim = input_prop_dim

    @property
    def num_outputs(self):
        return self.num_outputs_

    def KL(self):
        raise NotImplementedError(
            "CachedSVGPLayer is prediction-only: the staging factors are "
            "a frozen snapshot of (Z, kern, q_mu, q_sqrt).  Train the "
            "original model and re-run precompute().")

    def conditional_ND(self, X, full_cov=False):
        Kuf = self.kern.K(self.Z, X)                            # (M, B)
        G = self.Li @ Kuf                                       # (M, B)
        mean = G.T @ self.alpha                                 # (B, D)
        if full_cov:
            cov = self.kern.K(X) - G.T @ G                      # (B, B)
            H = torch.einsum("dim,ib->dmb", self.C, G)          # (D, M, B)
            var = cov[None] + torch.einsum("dmb,dmc->dbc", H, H)
            return mean + self.mean_function(X), var.permute(1, 2, 0)
        resid = self.kern.Kdiag(X) - torch.sum(G * G, dim=0)    # (B,)
        D_, M_, _ = self.C.shape
        CT = self.C.transpose(-1, -2).reshape(D_ * M_, M_)
        H = (CT @ G).reshape(D_, M_, G.shape[1])                # (D, M, B)
        var = resid[:, None] + torch.sum(H * H, dim=1).T
        var = torch.clamp(var, min=0.0)
        return mean + self.mean_function(X), var


def _frozen(module):
    module = copy.deepcopy(module)
    for p in module.parameters():
        p.requires_grad_(False)
    return module


@torch.no_grad()
def _cache_svgp(layer: SVGPLayer) -> CachedSVGPLayer:
    _, Lu = layer._chol_Kuu()
    Li = inv_lower(Lu)
    if layer.white:
        alpha, C = layer.q_mu.value, layer.q_sqrt.value
    else:
        alpha = Li @ layer.q_mu.value
        C = torch.einsum("ij,djk->dik", Li, layer.q_sqrt.value)
    return CachedSVGPLayer(
        kern=_frozen(layer.kern), Z=layer.Z.value.detach().clone(), Li=Li,
        alpha=alpha.detach().clone(), C=C.detach().clone(),
        mean_function=_frozen(layer.mean_function),
        num_outputs=layer.num_outputs, jitter=layer.jitter,
        input_prop_dim=layer.input_prop_dim)


def precompute(model):
    """A prediction-only copy of a Monte-Carlo DGP (``DGP``, ``DGPBase``,
    ``DGPQuad``, ``DGPHeteroscedastic``) whose SVGP layers are replaced by
    :class:`CachedSVGPLayer` snapshots.  The copy keeps the model's class,
    its buffers and so its y-space hooks; every parameter of it is frozen.
    Other model families are not ported yet."""
    if not isinstance(model, DGPBase):
        raise NotImplementedError(
            f"precompute: only the Monte-Carlo DGP family is ported; got "
            f"{type(model).__name__}")
    layers = []
    for layer in model.layers:
        if isinstance(layer, SVGPLayer):
            layers.append(_cache_svgp(layer))
        elif isinstance(layer, CachedSVGPLayer):
            layers.append(layer)
        else:
            raise NotImplementedError(
                f"precompute: layer type {type(layer).__name__} is not "
                f"ported yet")
    cached = copy.deepcopy(model)
    cached.layers = nn.ModuleList(layers)
    for p in cached.parameters():
        p.requires_grad_(False)
    return cached
