"""Precomputed-posterior (serving) cache.

Counterpart of ``doubly_stochastic_dgp_tpu/models/posterior.py``
(``CachedSVGPLayer``, ``CachedSingleLayerGP``, the layer caches and
``precompute``).  At serving time the parameters are frozen, so the
staging factors of a layer are computed once, and a prediction needs only
the grams and matmuls: G = Li Kuf, mean = G^T alpha + m(X), var = Kff -
colsum(G*G) + colsum(H*H) with H = C^T G (no H term when C is None) — the
same sum-of-squares form as the live ``solve_mode='inverse'`` branch — or,
with ``full_cov``, K(X) - G^T G + H^T H per output.  The factors of each
layer kind:

    SVGP   Li = Lu^-1, alpha = Li q_mu (q_mu if white), C = Li q_sqrt
           (q_sqrt if white; None for an SGPMC layer, which has none)
    GPMC   Z = X_fixed, Li = Lu^-1, alpha = q_mu, C None
    GPR    Z = X_data, Li = chol(Knn + sigma^2 I)^-1, alpha = Li (Y -
           m(X)), C None
    SGPR   (and FITC) Li = L^-1, alpha = LB^-T c, C = LB^-T: the
           ||C^T G||^2 term is the collapsed conditional's +||tmp2||^2

A collapsed layer's 1-column variance is tiled to its outputs
(``tile_var``) and a ``DGPDamianou`` inner layer adds its generative
noise sigma_l^2 (``extra_var``), as the live ``propagate`` does.  A
cached layer keeps its live layer's ``input_prop_dim``.  Every factor is
a buffer and every parameter of a cached model is frozen: the cache is a
snapshot, not an optimizable state.
"""

from __future__ import annotations

import copy
import warnings

import torch
from torch import nn

from ..ops.linalg import inv_lower
from .damianou import DGPDamianou
from .dgp import DGPBase
from .layers import GPMCLayer, GPRLayer, Layer, SGPRLayer, SVGPLayer
from .single_layer import DeterministicPredictions, GPR, GPRFITC, SGPR
from .zoo import DGPCollapsed, DGPHeinonen

__all__ = ["CachedSVGPLayer", "CachedSingleLayerGP", "precompute"]


class CachedSVGPLayer(Layer):
    """Prediction-only layer holding the staging factors as buffers: Z (M,
    D_in), Li (M, M), alpha (M, D), C (D, M, M) or None (a 1-column
    variance), and ``extra_var`` (a 0-dim noise variance added to the
    variance) or None.  ``tile_var`` repeats a 1-column variance to
    ``num_outputs``.  Every product here is full fp32 (or f64), as
    everywhere in the port, so the JAX ``precision`` field has no
    counterpart."""

    def __init__(self, kern, Z, Li, alpha, C, mean_function, num_outputs,
                 jitter, input_prop_dim=None, extra_var=None,
                 tile_var=False):
        super().__init__()
        self.kern = kern
        self.mean_function = mean_function
        self.register_buffer("Z", Z)
        self.register_buffer("Li", Li)
        self.register_buffer("alpha", alpha)
        self.register_buffer("C", C)
        self.register_buffer("extra_var", extra_var)
        self.num_outputs_ = int(num_outputs)
        self.jitter = float(jitter)
        self.input_prop_dim = input_prop_dim
        self.tile_var = bool(tile_var)

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
        mean = G.T @ self.alpha + self.mean_function(X)         # (B, D)
        if full_cov:
            cov = self.kern.K(X) - G.T @ G                      # (B, B)
            if self.C is None:
                var = cov[:, :, None]
            else:
                H = torch.einsum("dim,ib->dmb", self.C, G)      # (D, M, B)
                var = (cov[None] + torch.einsum("dmb,dmc->dbc", H, H)
                       ).permute(1, 2, 0)
            var = self._tile(var)
            if self.extra_var is not None:
                eye = torch.eye(var.shape[0], dtype=var.dtype,
                                device=var.device)
                var = var + self.extra_var * eye[:, :, None]
            return mean, var
        resid = self.kern.Kdiag(X) - torch.sum(G * G, dim=0)    # (B,)
        if self.C is None:
            var = resid[:, None]
        else:
            D_, M_, _ = self.C.shape
            CT = self.C.transpose(-1, -2).reshape(D_ * M_, M_)
            H = (CT @ G).reshape(D_, M_, G.shape[1])            # (D, M, B)
            var = resid[:, None] + torch.sum(H * H, dim=1).T
        var = self._tile(torch.clamp(var, min=0.0))
        if self.extra_var is not None:
            var = var + self.extra_var
        return mean, var

    def _tile(self, var):
        if self.tile_var and var.shape[-1] == 1 and self.num_outputs_ > 1:
            var = var.expand(*var.shape[:-1], self.num_outputs_)
        return var


class CachedSingleLayerGP(DeterministicPredictions, nn.Module):
    """Prediction-only cache of a single-layer baseline (GPR, SGPR,
    GPRFITC) with their deterministic prediction API; the per-request
    cost drops to a gram and matmuls."""

    def __init__(self, layer, likelihood):
        super().__init__()
        self.layer = layer
        self.likelihood = likelihood

    def _input_like(self):
        return self.layer.Z

    @torch.no_grad()
    def predict_f(self, Xnew, full_cov=False):
        return self.layer.conditional_ND(self._as_input(Xnew),
                                         full_cov=full_cov)

    def log_likelihood(self, X=None, Y=None):
        raise NotImplementedError(
            "CachedSingleLayerGP is prediction-only; train the original "
            "model and re-run precompute().")


def _frozen(module):
    module = copy.deepcopy(module)
    for p in module.parameters():
        p.requires_grad_(False)
    return module


def _snapshot(t):
    return t.detach().clone()


@torch.no_grad()
def _cache_svgp(layer: SVGPLayer) -> CachedSVGPLayer:
    _, Lu = layer._chol_Kuu()
    Li = inv_lower(Lu)
    q_sqrt = None if layer.q_sqrt is None else layer.q_sqrt.value
    if layer.white:
        alpha, C = layer.q_mu.value, q_sqrt
    else:
        alpha = Li @ layer.q_mu.value
        C = (None if q_sqrt is None
             else torch.einsum("ij,djk->dik", Li, q_sqrt))
    return CachedSVGPLayer(
        kern=_frozen(layer.kern), Z=_snapshot(layer.Z.value), Li=Li,
        alpha=_snapshot(alpha), C=None if C is None else _snapshot(C),
        mean_function=_frozen(layer.mean_function),
        num_outputs=layer.num_outputs, jitter=layer.jitter,
        input_prop_dim=layer.input_prop_dim)


@torch.no_grad()
def _cache_gpmc(layer: GPMCLayer) -> CachedSVGPLayer:
    """The whitened dense conditional is the SVGP cache with Z = X_fixed,
    Li = Lu^-1, alpha = q_mu and no C; its variance is repeated to the
    outputs (``tile_var``)."""
    return CachedSVGPLayer(
        kern=_frozen(layer.kern), Z=_snapshot(layer.X_fixed),
        Li=inv_lower(layer.Lu), alpha=_snapshot(layer.q_mu.value), C=None,
        mean_function=_frozen(layer.mean_function),
        num_outputs=layer.num_outputs, jitter=layer.jitter,
        input_prop_dim=layer.input_prop_dim, tile_var=True)


def _cache_gpr(layer: GPRLayer) -> CachedSVGPLayer:
    """A ``GPRLayer`` with its data set: Z = X_data, Li = chol(Knn +
    sigma^2 I)^-1, alpha = Li (Y - m(X)); no per-request O(N^3)
    Cholesky."""
    X, Y = layer.data.X_mean, layer.data.Y
    Li = inv_lower(layer._chol())
    return CachedSVGPLayer(
        kern=_frozen(layer.kern), Z=_snapshot(X), Li=Li,
        alpha=Li @ (Y - layer.mean_function(X)), C=None,
        mean_function=_frozen(layer.mean_function),
        num_outputs=Y.shape[1], jitter=layer.jitter,
        input_prop_dim=layer.input_prop_dim, tile_var=True)


def _titsias_factors(obj):
    """(Li = L^-1, alpha = LB^-T c, LB^-T) from the ``_common()`` of a
    collapsed SGPR layer or a GPRFITC model: both predict through the
    same tmp1 / tmp2 pipeline."""
    cm = obj._common()
    Li = inv_lower(cm["L"])
    LBiT = inv_lower(cm["LB"]).mT
    return Li, LBiT @ cm["c"], LBiT


def _cache_sgpr(layer: SGPRLayer, extra_var=None) -> CachedSVGPLayer:
    """An ``SGPRLayer`` with its data set: Li = L^-1, alpha = LB^-T c, C =
    LB^-T; the per-request cost drops from O(N M^2 + M^3) to O(B M^2).
    ``extra_var``: a ``DGPDamianou`` inner layer's generative noise."""
    Li, alpha, LBiT = _titsias_factors(layer)
    return CachedSVGPLayer(
        kern=_frozen(layer.kern), Z=_snapshot(layer.Z.value), Li=Li,
        alpha=alpha, C=LBiT[None],
        extra_var=None if extra_var is None else _snapshot(extra_var),
        mean_function=_frozen(layer.mean_function),
        num_outputs=layer.data.Y.shape[1], jitter=layer.jitter,
        input_prop_dim=layer.input_prop_dim, tile_var=True)


def _cache_fitc(model: GPRFITC) -> CachedSingleLayerGP:
    Li, alpha, LBiT = _titsias_factors(model)
    layer = CachedSVGPLayer(
        kern=_frozen(model.kern), Z=_snapshot(model.Z.value), Li=Li,
        alpha=alpha, C=LBiT[None], mean_function=_frozen(model.mean_function),
        num_outputs=model.Y_data.shape[1], jitter=model.jitter,
        tile_var=True)
    return CachedSingleLayerGP(layer, _frozen(model.likelihood))


def _cache_any(layer):
    if isinstance(layer, SVGPLayer):
        return _cache_svgp(layer)
    if isinstance(layer, GPMCLayer):
        return _cache_gpmc(layer)
    if isinstance(layer, CachedSVGPLayer):
        return layer
    raise NotImplementedError(
        f"precompute: layer type {type(layer).__name__} is not ported yet")


def _prediction_model(model, layers):
    """A prediction-only ``DGPBase`` over the cached stack: the collapsed
    classes' ``propagate`` and ``elbo`` re-derive their factorization
    from live state on every call, and the generic loop over the cached
    layers predicts as they do."""
    return DGPBase(_frozen(model.likelihood), layers,
                   _snapshot(model.X_data), _snapshot(model.Y_data),
                   num_samples=model.num_samples, num_data=model.num_data,
                   remat=model.remat)


@torch.no_grad()
def precompute(model, generator=None, zs=None):
    """A prediction-only copy of ``model`` with its layers replaced by
    :class:`CachedSVGPLayer` snapshots; every parameter of it is frozen.

    - ``GPR``, ``SGPR``, ``GPRFITC``: a :class:`CachedSingleLayerGP`.
    - ``DGPDamianou``: every collapsed layer cached from its q(H) data,
      the inner ones carrying sigma_l^2; a generic ``DGPBase``.
    - ``DGPCollapsed`` and ``DGPHeinonen``: the inner SVGP (or GPMC)
      layers cached, and the collapsed
      last layer snapshotted from the inner propagation of the training
      inputs, drawn from ``generator`` (default: seeded with 0) unless
      ``zs`` fixes it; a generic ``DGPBase``.  With more than one
      stochastic inner layer the snapshot freezes one draw where the
      live model draws anew each call, and a warning says so unless the
      draw was chosen.
    - the Monte-Carlo family (``DGP``, ``DGPBase``, ``DGPQuad``,
      ``DGPHeteroscedastic``, ``SVGP``): SVGP layers cached in place; the
      class, its buffers and its y-space hooks kept."""
    if isinstance(model, (GPR, SGPR)):
        lay = model._bound_layer()
        cached = (_cache_gpr(lay) if isinstance(lay, GPRLayer)
                  else _cache_sgpr(lay))
        return CachedSingleLayerGP(cached, _frozen(model.likelihood))
    if isinstance(model, GPRFITC):
        return _cache_fitc(model)
    if isinstance(model, DGPDamianou):
        L = len(model.layers)
        return _prediction_model(model, [
            _cache_sgpr(lay, extra_var=(model.noise[l].value if l < L - 1
                                        else None))
            for l, lay in enumerate(model._data_layers())])
    if isinstance(model, DGPCollapsed):
        if (generator is None and zs is None and len(model.layers) > 2
                and not isinstance(model, DGPHeinonen)):
            warnings.warn(
                "precompute(DGPCollapsed with >1 stochastic inner layer): "
                "the cached collapsed factorization freezes a single "
                "inner-propagation draw (a generator seeded with 0); live "
                "predictions re-draw it per call.  Pass generator= (or "
                "zs=) explicitly to choose the frozen draw.", stacklevel=2)
        last = model._collapsed_last_layer(generator=generator, zs=zs)
        cached_last = (_cache_gpr(last) if isinstance(last, GPRLayer)
                       else _cache_sgpr(last))
        return _prediction_model(
            model, [_cache_any(l) for l in model.layers[:-1]]
            + [cached_last])
    if not isinstance(model, DGPBase):
        raise NotImplementedError(
            f"precompute: {type(model).__name__} is not ported yet")
    layers = [_cache_any(layer) for layer in model.layers]
    cached = copy.deepcopy(model)
    cached.layers = nn.ModuleList(layers)
    for p in cached.parameters():
        p.requires_grad_(False)
    return cached
