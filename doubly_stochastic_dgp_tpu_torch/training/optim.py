"""The optimizers over a model's trainable parameters: Adam, the jitted
train step's counterpart and L-BFGS.

Counterpart of ``doubly_stochastic_dgp_tpu/training/optim.py``
(``masked_optimizer`` with ``optax.adam``, ``freeze_q_params``,
``make_train_step``, ``partition_trainable``, ``lbfgs_minimize``).  The
JAX package masks buffers and frozen Params out of the update with
``trainable_mask``; here a frozen ``Param`` has ``requires_grad=False``
and data are buffers, so the optimizer takes the parameters that require
grad, less those a ``freeze(name, param)`` predicate names (the JAX
``trainable_mask(freeze=)``, whose left-out leaves optax's
``set_to_zero`` never moves).

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

__all__ = ["Adam", "AdamState", "copy_state", "masked_optimizer",
           "freeze_q_params", "trainable_parameters", "value_and_grads",
           "make_train_step", "partition_trainable", "lbfgs_minimize"]


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


def freeze_q_params(layer_indices, num_layers: int):
    """A ``freeze(name, param)`` predicate that names the (q_mu, q_sqrt)
    of ``model.layers[i]`` for i in ``layer_indices`` (negative indices
    count from the end): the parameters a natural-gradient step moves, so
    the gradient optimizer leaves them out."""
    idxs = {i % num_layers for i in layer_indices}

    def freeze(name, param) -> bool:
        parts = name.split(".")
        return (len(parts) > 2 and parts[0] == "layers"
                and parts[1].isdigit() and int(parts[1]) in idxs
                and parts[2] in ("q_mu", "q_sqrt"))

    return freeze


def trainable_parameters(model, freeze=None):
    """The parameters of ``model`` that require grad and that ``freeze``
    (if given) does not name, in ``named_parameters`` order."""
    return [p for name, p in model.named_parameters()
            if p.requires_grad and not (freeze and freeze(name, p))]


def masked_optimizer(model, learning_rate: float = 0.01,
                     freeze=None) -> Adam:
    """Adam over :func:`trainable_parameters` of ``model``."""
    return Adam(trainable_parameters(model, freeze), lr=learning_rate)


def value_and_grads(loss_fn, params):
    """``loss_fn()`` (a 0-dim tensor, detached) and its gradients in
    ``params`` as values: zeros for a parameter it does not reach, as the
    JAX gradient of an unused leaf."""
    with torch.enable_grad():
        loss = loss_fn()
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(params, grads)]


def make_train_step(loss_fn, optimizer: Adam):
    """Step ``step(model, *args, **kwargs) -> loss``: one update of
    ``optimizer``'s parameters in place on ``loss_fn(model, *args,
    **kwargs)``; returns the loss as a 0-dim tensor (no host read)."""

    @torch.no_grad()
    def step(model, *args, **kwargs):
        loss, grads = value_and_grads(lambda: loss_fn(model, *args, **kwargs),
                                      optimizer.params)
        torch._foreach_add_(optimizer.params,
                            optimizer.update(grads, optimizer.state))
        return loss

    return step


def partition_trainable(model, freeze=None):
    """(flat, rebuild): the trainable parameters (as
    :func:`trainable_parameters` picks them) concatenated into one 1-D
    tensor, and ``rebuild(vec)``, which writes such a vector back into
    them in place and returns the model."""
    params = trainable_parameters(model, freeze)
    flat = torch.cat([p.detach().reshape(-1) for p in params])

    @torch.no_grad()
    def rebuild(vec):
        start = 0
        for p in params:
            p.copy_(vec[start:start + p.numel()].view_as(p))
            start += p.numel()
        return model

    return flat, rebuild


def lbfgs_minimize(loss_fn, model, max_iters: int = 500, tol: float = 1e-9,
                   freeze=None):
    """L-BFGS over the trainable parameters (the reference's
    ScipyOptimizer): ``torch.optim.LBFGS`` with memory 10 (optax's
    default) and a strong-Wolfe line search on the flat vector of
    :func:`partition_trainable`, one iteration at a time, until
    ``max_iters`` or until two successive losses differ by less than
    ``tol``, the JAX stopping rule.  Its trajectory is not optax's (zoom
    line search), its optimum is.  Returns (model, the last iteration's
    loss at its start), the model updated in place; the loop reads the
    loss on the host each iteration."""
    flat, rebuild = partition_trainable(model, freeze)
    params = trainable_parameters(model, freeze)
    vec = flat.clone().requires_grad_()
    # one iteration a step; max_eval bounds the evaluations of a step
    # and so the line search's (25, torch's default budget), beside the
    # step's own first evaluation
    opt = torch.optim.LBFGS([vec], lr=1.0, max_iter=1, max_eval=26,
                            history_size=10, tolerance_grad=0.0,
                            tolerance_change=0.0,
                            line_search_fn="strong_wolfe")

    def closure():
        rebuild(vec.detach())
        loss, grads = value_and_grads(lambda: loss_fn(model), params)
        vec.grad = torch.cat([g.reshape(-1) for g in grads])
        return loss

    prev = float("inf")
    loss = prev
    for _ in range(max_iters):
        loss = float(opt.step(closure))
        if abs(prev - loss) < tol:
            break
        prev = loss
    rebuild(vec.detach())
    return model, loss
