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
parameters), it yields the update ``u`` and the new state as values
(:meth:`Adam.update`), so the reject-nonfinite guard can scale the update
before it is applied and keep the previous state to roll back to; a
scale of exactly 1.0 leaves the update's bits as they are, so a guarded
step that never rejects is the plain step.  The state is a step count on
the host and two lists of tensors; every list operation is one
``torch._foreach_*`` call.  optax evaluates the formula in a different
order, so trajectories agree to rounding; a 20-step trajectory test pins
that in float64.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["Adam", "AdamState", "masked_optimizer"]


_B1, _B2, _EPS = 0.9, 0.999, 1e-8      # optax.adam's defaults


class AdamState(NamedTuple):
    count: int
    mu: list
    nu: list


class Adam:
    """Adam over a list of parameters, with the update as a value."""

    def __init__(self, params, lr=0.01):
        self.params = list(params)
        self.lr = lr
        self.state = self.init()

    def init(self) -> AdamState:
        return AdamState(0, [torch.zeros_like(p) for p in self.params],
                         [torch.zeros_like(p) for p in self.params])

    def grads(self):
        """The parameters' ``.grad``, zeros for a parameter the objective
        did not reach (its update is then 0, as in the JAX package, whose
        gradient of an unused leaf is 0)."""
        return [torch.zeros_like(p) if p.grad is None else p.grad
                for p in self.params]

    @torch.no_grad()
    def update(self, grads, state: AdamState):
        """(updates, new state) for ``grads`` at ``state``; changes
        neither.  The step is ``p + u`` for each update ``u``."""
        count = state.count + 1
        mu = torch._foreach_mul(state.mu, _B1)
        torch._foreach_add_(mu, grads, alpha=1.0 - _B1)
        nu = torch._foreach_mul(state.nu, _B2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - _B2)
        denom = torch._foreach_div(nu, 1.0 - _B2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, _EPS)
        updates = torch._foreach_div(mu, denom)
        torch._foreach_mul_(updates, -self.lr / (1.0 - _B1 ** count))
        return updates, AdamState(count, mu, nu)

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self):
        """One Adam step in place from the parameters' ``.grad``."""
        updates, self.state = self.update(self.grads(), self.state)
        torch._foreach_add_(self.params, updates)


def masked_optimizer(model, learning_rate: float = 0.01) -> Adam:
    """Adam over the parameters of ``model`` that require grad."""
    return Adam([p for p in model.parameters() if p.requires_grad],
                lr=learning_rate)
