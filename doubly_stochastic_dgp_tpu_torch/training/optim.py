"""The optimizer over a model's trainable parameters.

Counterpart of ``doubly_stochastic_dgp_tpu/training/optim.py::
masked_optimizer`` with ``optax.adam``.  The JAX package masks buffers and
frozen Params out of the update with ``trainable_mask``; here a frozen
``Param`` has ``requires_grad=False`` and data are buffers, so the
optimizer simply takes the parameters that require grad.

:class:`Adam` is ``optax.adam``'s formula with its defaults (b1 = 0.9,
b2 = 0.999, eps = 1e-8 added to the bias-corrected sqrt(v), no weight
decay):

    m <- b1 m + (1 - b1) g,   v <- b2 v + (1 - b2) g^2,
    u = -lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps),   p <- p + u.

Like optax, and unlike ``torch.optim.Adam`` (whose ``step`` writes the
parameters), it yields the update ``u`` as a value (:meth:`Adam.update`),
so the reject-nonfinite guard can scale the update before it is applied
and select the next state on the device; a scale of exactly 1.0 leaves
the update's bits as they are, so a guarded step that never rejects is
the plain step.  The state is a step count on the device (a 0-dim int64
tensor) and two lists of tensors, all advanced in place: the bias
corrections 1 - b^t are computed on the device from the count, so a
captured CUDA graph that replays :meth:`Adam.update` reads and writes the
same tensors each time and bakes in no step number.  Every list
operation is one ``torch._foreach_*`` call.  optax evaluates the formula
in a different order, so trajectories agree to rounding; a 20-step
trajectory test pins that in float64.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["Adam", "AdamState", "copy_state", "masked_optimizer"]


_B1, _B2, _EPS = 0.9, 0.999, 1e-8      # optax.adam's defaults


class AdamState(NamedTuple):
    count: torch.Tensor     # 0-dim int64 on the parameters' device
    mu: list
    nu: list


def copy_state(state: AdamState) -> AdamState:
    """A copy of ``state`` in new tensors."""
    return AdamState(state.count.clone(), [m.clone() for m in state.mu],
                     [v.clone() for v in state.nu])


class Adam:
    """Adam over a list of parameters, with the update as a value."""

    def __init__(self, params, lr=0.01):
        self.params = list(params)
        self.lr = lr
        self.state = self.init()

    def init(self) -> AdamState:
        device = self.params[0].device if self.params else None
        return AdamState(torch.zeros((), dtype=torch.int64, device=device),
                         [torch.zeros_like(p) for p in self.params],
                         [torch.zeros_like(p) for p in self.params])

    @torch.no_grad()
    def update(self, grads, state: AdamState):
        """The updates for ``grads`` at ``state``, which advances in place
        (count, mu, nu); the step is ``p + u`` for each update ``u``.  No
        host read: the count and the bias corrections stay on the
        device, the corrections in float64, cast to the parameters'
        dtype where they scale a tensor."""
        state.count.add_(1)
        t = state.count.to(torch.float64)
        dtype = state.mu[0].dtype
        torch._foreach_mul_(state.mu, _B1)
        torch._foreach_add_(state.mu, grads, alpha=1.0 - _B1)
        torch._foreach_mul_(state.nu, _B2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - _B2)
        denom = torch._foreach_div(state.nu,
                                   (1.0 - torch.pow(_B2, t)).to(dtype))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, _EPS)
        updates = torch._foreach_div(state.mu, denom)
        torch._foreach_mul_(updates,
                            (-self.lr / (1.0 - torch.pow(_B1, t))).to(dtype))
        return updates


def masked_optimizer(model, learning_rate: float = 0.01) -> Adam:
    """Adam over the parameters of ``model`` that require grad."""
    return Adam([p for p in model.parameters() if p.requires_grad],
                lr=learning_rate)
