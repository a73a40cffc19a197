"""Carry a JAX model's state into a port model of the same structure.

``state`` maps the JAX model's pytree key paths, as
``jax.tree_util.keystr`` prints them (``.layers[0].q_mu.unconstrained``),
to numpy arrays of ``Param.unconstrained`` values and buffers.  The port
only sees numpy: the caller does the flattening on the JAX side.  Any
model whose parameter and buffer names follow the JAX fields is covered:
``DGP`` and ``DGPBase`` (also with input propagation),
``DGPHeteroscedastic``, ``DGPQuad`` (also its grids ``gh_x[i]`` and
weights ``gh_w``), ``DGPCollapsed`` (SVGP layers and an ``SGPRLayer``'s
``Z`` and ``kern``) and ``DGPDamianou`` (also ``h_mean[l]``,
``h_var[l]`` and ``noise[l]``), ``DGPHeinonen`` (a ``GPMCLayer``'s
``X_fixed`` and ``Lu`` buffers and its (N, D) ``q_mu``, then a
``GPRLayer``), and stacks of ``SGPMCLayer`` (no ``q_sqrt`` key), on every
kernel, ``Sum`` and ``Product`` and every mean function (``Constant``'s
``c``).
"""

from __future__ import annotations

import re

import numpy as np
import torch

__all__ = ["load_reference_state"]


def _torch_key(jax_path: str) -> str:
    """'.layers[0].kern.kernels[1].variance.unconstrained' ->
    'layers.0.kern.kernels.1.variance.unconstrained'."""
    return re.sub(r"\[(\d+)\]", r".\1", jax_path).lstrip(".")


def load_reference_state(model, state):
    """Write ``state`` into ``model`` in place (values cast to each
    tensor's dtype and device).  Raises on a missing key, an extra key or
    a shape mismatch."""
    targets = dict(model.named_parameters())
    targets.update(model.named_buffers())
    given = {_torch_key(k): (k, np.array(v)) for k, v in state.items()}
    missing = sorted(set(targets) - set(given))
    extra = sorted(given[k][0] for k in set(given) - set(targets))
    if missing or extra:
        raise KeyError(f"load_reference_state: missing {missing}, "
                       f"extra {extra}")
    for key, (jax_key, value) in given.items():
        t = targets[key]
        if tuple(value.shape) != tuple(t.shape):
            raise ValueError(
                f"load_reference_state: {jax_key} has shape {value.shape}, "
                f"the port's {key} has {tuple(t.shape)}")
    with torch.no_grad():
        for key, (_, value) in given.items():
            t = targets[key]
            t.copy_(torch.as_tensor(value, dtype=t.dtype, device=t.device))
    return model
