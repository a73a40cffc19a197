"""Constrained parameters: bijectors and the ``Param`` module.

Counterpart of the bijector half of ``doubly_stochastic_dgp_tpu/
utils/modules.py`` (``positive``/``positive_inverse``/``_tril`` and
``Param``).  A ``Param`` holds the *unconstrained* tensor as an
``nn.Parameter`` (``requires_grad`` = its ``trainable`` flag) and applies
its bijector in ``.value``; the maps match the JAX ones exactly, so the
same unconstrained arrays give the same constrained values.  A ``Param``
may carry a ``prior`` (``("gaussian", mu, sigma)`` on its constrained
value), summed by :func:`log_prior` — the counterpart of the JAX
``log_prior``.  Trainability is ``requires_grad``: the optimizer takes the
parameters that require grad, as the JAX ``trainable_mask`` keeps frozen
Params and buffers out of the update.

:func:`module_view` is the counterpart of a JAX pytree rebuilt with other
leaves (``tree_map`` over a layer, ``layer.replace(...)``): a shallow copy
of a module tree whose parameters and buffers are tensors derived from
the original's (a slice, a stacked layer's row), so gradients reach the
original and nothing assigned to the view writes through to it.
"""

from __future__ import annotations

import copy
import math

import torch
from torch import nn

__all__ = ["Param", "positive", "positive_inverse", "BIJECTORS",
           "log_prior", "module_view", "owner_of"]

_SOFTPLUS_LOWER = 1e-6  # keeps positive params bounded away from zero


def positive(u):
    """softplus(u) + lower bound (softplus as logaddexp(u, 0), the JAX
    formula, so large u are not cut at a threshold)."""
    return torch.logaddexp(u, torch.zeros_like(u)) + _SOFTPLUS_LOWER


def positive_inverse(v):
    """Inverse of :func:`positive`.  Values at or below the floor are
    clamped to a tiny positive offset instead of giving -inf/NaN."""
    v = v - _SOFTPLUS_LOWER
    v = torch.clamp(v, min=1e-20)
    # softplus^-1(v) = log(expm1(v)) = v + log1p(-exp(-v))
    return v + torch.log(-torch.expm1(-v))


BIJECTORS = {
    "identity": (lambda u: u, lambda v: v),
    "positive": (positive, positive_inverse),
    # full-matrix storage, strict upper triangle masked on the way out
    "triangular": (torch.tril, torch.tril),
}


class Param(nn.Module):
    """A constrained parameter: ``unconstrained`` is the stored tensor and
    ``.value`` its bijector image."""

    def __init__(self, value, bijector="identity", trainable=True,
                 dtype=torch.float64, prior=None):
        super().__init__()
        if bijector not in BIJECTORS:
            raise ValueError(f"unknown bijector {bijector!r}")
        if prior is not None and prior[0] != "gaussian":
            raise NotImplementedError(f"prior {prior[0]!r}")
        self.bijector = bijector
        self.prior = None if prior is None else tuple(prior)
        # a copy: as_tensor shares a float64 numpy array's memory, which
        # would alias Params built from one array (the dim-matched layers'
        # inducing points) and train them as one
        value = torch.as_tensor(value, dtype=dtype).detach().clone()
        self.unconstrained = nn.Parameter(BIJECTORS[bijector][1](value),
                                          requires_grad=bool(trainable))

    @property
    def trainable(self) -> bool:
        return self.unconstrained.requires_grad

    @property
    def value(self):
        return BIJECTORS[self.bijector][0](self.unconstrained)

    def set_value(self, value):
        """Overwrite in place from a constrained value."""
        with torch.no_grad():
            self.unconstrained.copy_(BIJECTORS[self.bijector][1](
                torch.as_tensor(value, dtype=self.unconstrained.dtype,
                                device=self.unconstrained.device)))

    def extra_repr(self):
        return (f"{self.bijector}, shape={tuple(self.unconstrained.shape)}, "
                f"trainable={self.trainable}, prior={self.prior}")


def log_prior(module):
    """Sum of prior log-densities over every ``Param`` in ``module`` that
    carries a prior (a 0-dim tensor; 0 when none does)."""
    p0 = next(module.parameters(), None)
    total = torch.zeros((), dtype=torch.float64 if p0 is None else p0.dtype,
                        device=None if p0 is None else p0.device)
    for m in module.modules():
        if isinstance(m, Param) and m.prior is not None:
            _, mu, sigma = m.prior
            v = m.value
            total = total + torch.sum(
                -0.5 * math.log(2 * math.pi * sigma ** 2)
                - 0.5 * ((v - mu) / sigma) ** 2)
    return total


def module_view(module, leaf, prefix: str = ""):
    """A view of ``module`` for computing: a shallow copy of it and of
    every submodule, each with parameter, buffer and submodule dicts of
    its own, where each parameter and buffer ``t`` named ``name`` (as
    ``named_parameters`` names it under ``prefix``) becomes the plain
    tensor attribute ``leaf(name, t)``.  The view shares everything else
    (its submodules' methods and static fields); assigning to it, or to
    a submodule of it, leaves ``module`` as it was.  It holds no
    parameters of its own, so it is not trained: gradients flow through
    ``leaf``'s tensors to ``module``'s."""
    view = copy.copy(module)
    d = view.__dict__
    d["_parameters"], d["_buffers"], d["_modules"] = {}, {}, {}
    d["_non_persistent_buffers_set"] = set()
    for store in (module._parameters, module._buffers):
        for name, t in store.items():
            if t is not None:
                d[name] = leaf(prefix + name, t)
    for name, sub in module._modules.items():
        d["_modules"][name] = (None if sub is None else
                               module_view(sub, leaf, f"{prefix}{name}."))
    return view


def owner_of(module, name):
    """(the submodule that holds the parameter or buffer ``name``, its
    attribute name there)."""
    *path, attr = name.split(".")
    for part in path:
        module = getattr(module, part)
    return module, attr
