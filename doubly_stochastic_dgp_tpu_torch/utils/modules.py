"""The parameter table and numerics rewrites of a model.

Counterpart of ``summary`` and ``with_config`` in
``doubly_stochastic_dgp_tpu/utils/modules.py``.  ``summary`` prints one
row per :class:`Param` with the JAX table's columns, widths and value
digest; its paths are the JAX key paths as ``convert.py`` maps them
(``layers.0.kern.lengthscales``).  ``with_config`` returns an independent
copy of a model whose plain numerics attributes (``jitter``,
``solve_mode``, ``use_pallas``, ``precision``, ``psi2_impl``, ``remat``,
``num_samples``, ...) are replaced wherever a submodule holds them: the
port's way to flip the numerics of a model that is already built, as the
JAX package's is."""

from __future__ import annotations

import copy

import torch
from torch import nn

from .params import Param

__all__ = ["summary", "with_config"]


def _digest(a):
    """Scalars and up to 4 values inline, otherwise mean +- std (the JAX
    rules, on the host copy in the tensor's own dtype)."""
    if a.size == 1:
        return f"{float(a):.5g}"
    if a.size <= 4:
        return "[" + ", ".join(f"{x:.4g}" for x in a.ravel()) + "]"
    return f"mean={a.mean():.4g} +- {a.std():.4g}"


def summary(model, name: str = "model") -> str:
    """The parameter table of ``model``: path, constrained shape and
    dtype, bijector, trainability, prior and a value digest, one row per
    :class:`Param` in registration order (the JAX field order).  Buffers
    (a cached posterior's factors, the training data) are left out, as
    the JAX table leaves out bare leaves.  Values on the card are copied
    to the host; call as ``print(summary(model))``."""
    rows = []
    for path, m in model.named_modules():
        if not isinstance(m, Param):
            continue
        with torch.no_grad():
            v = m.value.detach().cpu().numpy()
        rows.append((
            path or name,
            "x".join(str(s) for s in v.shape) or "()",
            str(v.dtype),
            m.bijector,
            "yes" if m.trainable else "no",
            "-" if m.prior is None else f"{m.prior[0]}{tuple(m.prior[1:])}",
            _digest(v),
        ))
    header = ("path", "shape", "dtype", "bijector", "trainable", "prior",
              "value")
    widths = [max(len(r[i]) for r in rows + [header]) for i in
              range(len(header))]
    fmt = "  ".join("{:<%d}" % w for w in widths)
    lines = [fmt.format(*header), fmt.format(*("-" * w for w in widths))]
    lines += [fmt.format(*r) for r in rows]
    return "\n".join(lines)


_MISSING = object()


def with_config(model, **updates):
    """A copy of ``model`` in which every submodule that holds a plain
    (neither tensor nor module) attribute named in ``updates`` has it
    replaced; names that no submodule holds are ignored, as in JAX.

    The copy is independent: it has parameters and buffers of its own, so
    training it leaves the original's tensors as they were (the JAX
    package's value semantics).  A server or captured chunk made from the
    original keeps the original's route: graphs live in ``make_server``'s
    and ``fit``'s objects, never on a model.  ``use_pallas='auto'`` set
    this way raises when a layer is evaluated (``Config`` would refuse
    it)."""
    new = copy.deepcopy(model)
    for m in new.modules():
        for key, value in updates.items():
            old = m.__dict__.get(key, _MISSING)
            if old is _MISSING or isinstance(old, (torch.Tensor, nn.Module)):
                continue
            setattr(m, key, value)
    return new
