"""Pipeline parallelism over the DGP layer stack (GPipe schedule).

Counterpart of ``doubly_stochastic_dgp_tpu/parallel/pp.py``, the fourth
mesh axis beside data and sample (``parallel/dp.py``) and output-dim
(``parallel/outdim.py``) parallelism: the L layers of a homogeneous stack
split over a ``stage`` mesh axis, so that a rank placed by
:func:`pp_shard` holds only its L / n_stages layers' parameters (q_mu,
q_sqrt, Z, kernel and mean parameters): the memory axis for deep trunks
whose per-layer state dominates the card's memory.

Schedule: the minibatch splits into ``n_micro`` microbatches that flow
through the stages GPipe-style, over T = n_micro + n_stages - 1 ticks.
Each tick :func:`~.mesh.shift` hands every stage the activation (the
sampled (S, b, D) layer output) its predecessor produced at the last
tick, stage 0 takes microbatch t in its place, and every stage applies
its own layers.  Bubble ticks process what they hold and are masked out
of the likelihood sum, so the value and its gradients (through the
shift's backward) are the single-process ones.  The per-layer KLs are
local to their stage and summed over the stages once.

Every rank runs the same graph: the stage index selects by
``torch.where``, never by a Python branch, so each rank issues the same
collectives in the same order in the forward and in autograd's backward
(a branch would leave a rank's backward collective without its peers).

Restrictions (:func:`pp_stack` raises, with the JAX messages): all
layers of the stack share one class, structure (every static field) and
parameter shapes, D_in == D_out, and no input propagation.  L must divide
the stage axis and the batch ``n_micro``.

An optional ``data_axis`` composes with data parallelism: rows split over
it, every data replica runs its own pipeline, and the likelihood is
summed over both axes (a data x stage mesh).

A stacked model is ``pp_stack``'s copy of the model: its ``layers[0]`` is
a layer of the stack's class whose every parameter and buffer holds the
L layers' stacked on a leading axis (the JAX stacked pytree), and
``layers[1]``, under ``split_final``, the final layer.  A rank computes
with views of its layers (``utils.params.module_view``, each leaf's row
of the stack).  The model on every rank may be the whole stacked one or
placed by :func:`pp_shard`.  Gradients follow the rule of
``parallel/mesh.py``: one all-reduce sums the replicated leaves'
gradients; a placed rank's stage leaves keep their own (summed over the
data axis), with Adam state for them only.

The steps run eagerly, one dispatch a step, as ``make_dp_train_step``.
"""

from __future__ import annotations

import copy
import warnings
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..graphs import randn
from ..serving import derive_seed
from ..utils.params import module_view, owner_of
from .dp import make_sharded_train_step
from .mesh import (all_reduce, axis_index, axis_size, rank_generator,
                   replicate, shard_along, shift)

__all__ = ["pp_stack", "pp_specs", "pp_shard", "pp_elbo",
           "make_pp_train_step"]


def _statics(layer):
    """The structure of a layer that the JAX pytree structure holds: each
    submodule's name, class and static fields, its parameters' names and
    trainability, its buffers' names."""
    out = []
    for name, m in layer.named_modules():
        statics = {k: v for k, v in vars(m).items()
                   if not k.startswith("_") and k != "training"
                   and not isinstance(v, (torch.Tensor, nn.Module))}
        out.append((name, type(m), statics,
                    [(n, p.requires_grad) for n, p in m._parameters.items()
                     if p is not None],
                    [n for n, b in m._buffers.items() if b is not None]))
    return out


def _leaves(layer):
    return list(layer.named_parameters()) + list(layer.named_buffers())


def _stack(layers):
    """One layer of the stack's class whose every parameter and buffer
    holds the layers' stacked along a new leading (L,) axis."""
    stacked = copy.deepcopy(layers[0])
    each = [dict(_leaves(layer)) for layer in layers]
    with torch.no_grad():
        for name, p in list(stacked.named_parameters()):
            owner, attr = owner_of(stacked, name)
            setattr(owner, attr, nn.Parameter(
                torch.stack([e[name].detach() for e in each]),
                requires_grad=p.requires_grad))
        for name, _ in list(stacked.named_buffers()):
            owner, attr = owner_of(stacked, name)
            owner.register_buffer(attr, torch.stack([e[name] for e in each]))
    stacked.pp_layers = len(layers)
    return stacked


def pp_stack(model, split_final: bool = False):
    """A copy of ``model`` whose homogeneous layer list is stacked into
    one layer (module docstring) — the leading axis :func:`pp_specs`
    splits over stages.  Raises unless the stack is homogeneous:
    identical layer class, structure (every static field), parameter
    shapes, square D_in == D_out (the activation width must be constant
    through the pipe) and no input propagation.

    ``split_final=True`` handles the paper's canonical shape (equal
    hidden widths under a different final layer, e.g. RBF+White D -> D
    trunks under an RBF D -> D_Y Zero-mean head): only ``layers[:-1]``
    stack and split over stages; the final layer rides along replicated
    (``layers`` becomes ``[stacked_trunk, final]``) and the last stage
    evaluates its conditional moments for the likelihood term: the ELBO
    needs no sample from the final layer."""
    layers = list(model.layers)
    final = None
    if split_final:
        if len(layers) < 3:
            raise ValueError("split_final pipeline parallelism needs at "
                             "least a 2-layer trunk + the final layer")
        final = layers[-1]
        layers = layers[:-1]
    if len(layers) < 2:
        raise ValueError("pipeline parallelism needs at least 2 layers")
    t0 = type(layers[0])
    s0 = _statics(layers[0])
    shapes0 = [tuple(t.shape) for _, t in _leaves(layers[0])]
    for i, layer in enumerate(layers[1:], start=1):
        if type(layer) is not t0:
            raise ValueError(
                f"pp_stack needs a homogeneous stack: layer 0 is "
                f"{t0.__name__}, layer {i} is {type(layer).__name__}")
        if _statics(layer) != s0:
            raise ValueError(
                f"pp_stack: layer {i}'s pytree structure (incl. static "
                f"fields) differs from layer 0's — the stack is not "
                f"homogeneous")
        shapes = [tuple(t.shape) for _, t in _leaves(layer)]
        if shapes != shapes0:
            raise ValueError(
                f"pp_stack: layer {i}'s parameter shapes {shapes} differ "
                f"from layer 0's {shapes0}")
    for i, layer in enumerate(layers):
        if getattr(layer, "input_prop_dim", None):
            raise ValueError(
                f"pp_stack: layer {i} uses input propagation, which "
                f"changes the activation width between stages")
        Z = getattr(layer, "Z", None)
        D_in = Z.value.shape[1] if Z is not None else None
        if D_in is not None and D_in != layer.num_outputs:
            raise ValueError(
                f"pp_stack: layer {i} maps D_in={D_in} -> "
                f"D_out={layer.num_outputs}; the pipelined activation must "
                f"keep one width")
    if final is not None:
        fZ = getattr(final, "Z", None)
        if fZ is not None and fZ.value.shape[1] != layers[0].num_outputs:
            raise ValueError(
                f"pp_stack: the final layer consumes width "
                f"{fZ.value.shape[1]} but the trunk produces "
                f"{layers[0].num_outputs}")
        if getattr(final, "input_prop_dim", None):
            raise ValueError("pp_stack: the final layer uses input "
                             "propagation, which the pipeline does not "
                             "carry")
    out = copy.deepcopy(model)
    trunk = list(out.layers) if final is None else list(out.layers)[:-1]
    out.layers = nn.ModuleList([_stack(trunk)] + (
        [] if final is None else [out.layers[-1]]))
    return out


def pp_specs(model, axis: str = "stage"):
    """{parameter or buffer name: its PartitionSpec as a tuple} of a
    :func:`pp_stack`-ed model: every leaf of the stacked trunk
    (``layers.0``) splits its leading (L,) axis over ``axis``; everything
    else (a split-final head, the likelihood, the data) is replicated."""
    named = list(model.named_parameters()) + list(model.named_buffers())
    return {name: ((axis,) + (None,) * (t.ndim - 1)
                   if name.startswith("layers.0.") else (None,) * t.ndim)
            for name, t in named}


def _n_layers_divide(L, n_stages, axis):
    if L % n_stages != 0:
        raise ValueError(f"L={L} layers must divide over the '{axis}' "
                         f"axis ({n_stages} stages)")
    return L // n_stages


def pp_shard(model, mesh, axis: str = "stage"):
    """A copy of the stacked ``model`` placed on the mesh: its trunk holds
    only this rank's stage, L / n_stages layers (their memory divides by
    the stage count); everything else is rank 0's, broadcast."""
    n, s = axis_size(mesh, axis), axis_index(mesh, axis)
    L_local = _n_layers_divide(model.layers[0].pp_layers, n, axis)
    placed = copy.deepcopy(model)
    replicate(placed, mesh)
    stacked = placed.layers[0]
    with torch.no_grad():
        for name, p in list(stacked.named_parameters()):
            owner, attr = owner_of(stacked, name)
            setattr(owner, attr, nn.Parameter(
                p.detach().narrow(0, s * L_local, L_local).clone(),
                requires_grad=p.requires_grad))
        for name, b in list(stacked.named_buffers()):
            owner, attr = owner_of(stacked, name)
            owner.register_buffer(attr,
                                  b.narrow(0, s * L_local, L_local).clone())
    placed.pp_placed = (axis, n)
    return placed


def _stage(model, axis, n_stages, s_idx):
    """(the views of this stage's layers, L, L_local): rows of a placed
    model's trunk, or of the whole stack's block of the stage."""
    stacked = model.layers[0]
    L = stacked.pp_layers
    L_local = _n_layers_divide(L, n_stages, axis)
    placed = getattr(model, "pp_placed", None)
    if placed is not None and placed != (axis, n_stages):
        raise ValueError(f"the model is placed on {placed}, not on "
                         f"('{axis}', {n_stages})")
    first = 0 if placed is not None else s_idx * L_local
    views = [module_view(stacked, lambda name, t, i=first + i: t[i])
             for i in range(L_local)]
    return views, L, L_local


def _stage_params(model):
    """A placed model's trunk parameters (this stage's own), else []."""
    if getattr(model, "pp_placed", None) is None:
        return []
    return list(model.layers[0].parameters())


def pp_elbo(model, X, Y, seed, mesh, axis: str = "stage",
            n_micro: Optional[int] = None, data_axis: Optional[str] = None,
            batch_size: Optional[int] = None, zs=None):
    """The pipeline-parallel ELBO: the single-process ELBO on the same
    draws.

    ``model`` comes from :func:`pp_stack` (placed by :func:`pp_shard` or
    whole).  ``n_micro`` microbatches (default: the stage-axis size) flow
    through the stages; the batch must divide by ``n_micro`` (and by the
    data-axis size first, when ``data_axis`` is given).

    Random numbers (``zs`` None; for emulation and tests): the normals of
    global layer ``gl`` on microbatch ``j`` are ``randn((S, b, D))`` from
    ``rank_generator(seed', gl * n_micro + j)``, where ``seed'`` is
    ``seed``, or ``derive_seed(seed, data index)`` when ``data_axis`` is
    set (JAX folds the key with the data index, the layer and the
    microbatch).

    ``zs``: a stacked (L, S, N, D) tensor of fixed normals (the trunk
    layers only under ``split_final``), split (stage, -, data, -); it
    pins the draws.

    A model from ``pp_stack(..., split_final=True)`` carries its final
    layer replicated: every stage evaluates its conditional moments on
    its trunk output, the last stage's are scored (no sample: the bound
    consumes only the final moments), and its KL is added once, outside
    the sum over stages.

    With ``remat`` (the model's ``Config.remat``) each tick's stage is
    recomputed in the backward pass (``torch.utils.checkpoint``), its
    normals drawn before the call: the same values and gradients.

    **Bubble cost**: of the T = n_micro + n_stages - 1 ticks, n_stages -
    1 are fill and drain bubbles, an idle fraction (n_stages - 1) / T:
    half less one tick at the default n_micro = n_stages.  Raise
    ``n_micro`` to amortize it (about 33% at 2 n_stages, 11% at 8
    n_stages), keeping each microbatch (B / n_micro rows) large enough to
    keep the card busy.  A warning fires when n_micro < 2 n_stages: the
    pipeline is a parameter-memory lever, not a throughput lever."""
    from ..models.dgp import DGPBase
    if (type(model).E_log_p_Y is not DGPBase.E_log_p_Y
            or type(model).elbo is not DGPBase.elbo):
        raise ValueError(
            f"pp_elbo pipelines the standard MC bound "
            f"(DGPBase.E_log_p_Y); {type(model).__name__} overrides it "
            f"(quadrature / heteroscedastic / collapsed bounds) — use "
            f"that model's dedicated training path")
    n_stages = axis_size(mesh, axis)
    s_idx = axis_index(mesh, axis)
    views, L, L_local = _stage(model, axis, n_stages, s_idx)
    final = model.layers[1] if len(model.layers) > 1 else None
    n_micro = n_micro or n_stages
    if n_stages > 1 and n_micro < 2 * n_stages:
        bubble = (n_stages - 1) / (n_micro + n_stages - 1)
        warnings.warn(
            f"pp_elbo: n_micro={n_micro} with {n_stages} stages leaves "
            f"{bubble:.0%} of the pipeline ticks as fill/drain bubbles "
            f"(idle fraction = (n_stages-1)/(n_micro+n_stages-1)); "
            f"raise n_micro to >= {2 * n_stages} to push it below ~33%",
            stacklevel=2)
    n_data = axis_size(mesh, data_axis) if data_axis is not None else 1
    X, Y = model._as_input(X), model._as_input(Y)
    N = X.shape[0]
    if N % (n_data * n_micro) != 0:
        raise ValueError(
            f"batch N={N} must divide by data-axis size {n_data} x "
            f"n_micro={n_micro}")
    B = batch_size or N
    S = model.num_samples
    T = n_micro + n_stages - 1
    if data_axis is not None:
        X, Y = shard_along(X, mesh, data_axis), shard_along(Y, mesh,
                                                            data_axis)
    b = X.shape[0] // n_micro
    D = X.shape[1]
    X_mb = X.reshape(n_micro, b, D)
    Y_mb = Y.reshape(n_micro, b, Y.shape[1])
    if zs is not None:
        zs = torch.as_tensor(torch.stack(list(zs)) if isinstance(
            zs, (list, tuple)) else zs, dtype=X.dtype, device=X.device)
        zs = zs.narrow(0, s_idx * L_local, L_local)
        if data_axis is not None:
            zs = shard_along(zs, mesh, data_axis, dim=2)
    else:
        base = 0 if seed is None else seed
        if data_axis is not None:
            base = derive_seed(base, axis_index(mesh, data_axis))

    def draws(j):
        """The normals of this stage's layers on microbatch j."""
        if zs is not None:
            return [zs[i, :, j * b:(j + 1) * b] for i in range(L_local)]
        return [randn((S, b, D), rank_generator(
            base, (s_idx * L_local + i) * n_micro + j, X.device), X.dtype,
            X.device) for i in range(L_local)]

    def stage_fn(act_in, *z):
        """This stage's layers on the activation it holds (garbage on
        bubble ticks, masked out below), and the split-final head's
        moments on their output."""
        F = act_in
        mean = var = None
        for layer, z_i in zip(views, z):
            F, mean, var = layer.sample_from_conditional(F, z=z_i)
        if final is not None:
            mean, var = final.conditional_SND(F)
        return F, mean, var

    remat = getattr(model, "remat", False) and torch.is_grad_enabled()
    zero = torch.zeros((), dtype=X.dtype, device=X.device)
    # the masks as one tensor, one copy to the device a call: [0] stage 0
    # (takes the injected microbatch), [1 + t] tick t's output is scored
    # (the last stage, on a real microbatch)
    masks = torch.tensor(
        [s_idx == 0] + [s_idx == n_stages - 1
                        and 0 <= t - (n_stages - 1) < n_micro
                        for t in range(T)], device=X.device)
    first = masks[0]
    act = torch.zeros((S, b, D), dtype=X.dtype, device=X.device)
    ve_sum = zero
    for t in range(T):
        # last tick's activations one stage forward; stage 0 has no
        # upstream and takes microbatch t instead
        act_in = shift(act, mesh, axis) if n_stages > 1 else act
        inj = X_mb[min(t, n_micro - 1)][None].expand(S, b, D)
        act_in = torch.where(first, inj, act_in)
        z = draws(min(max(t - s_idx, 0), n_micro - 1))
        if remat:
            act, mean, var = checkpoint(stage_fn, act_in, *z,
                                        use_reentrant=False,
                                        preserve_rng_state=False)
        else:
            act, mean, var = stage_fn(act_in, *z)
        # the last stage holds global layer L - 1's output of microbatch
        # t - (n_stages - 1): scored when that microbatch is real
        j_out = t - (n_stages - 1)
        Yj = Y_mb[min(max(j_out, 0), n_micro - 1)]
        ve = model.likelihood.variational_expectations(mean, var, Yj)
        ve_j = torch.sum(torch.mean(ve, dim=0))
        ve_sum = ve_sum + torch.where(masks[1 + t], ve_j, zero)
    # the likelihood partials: only the last stage (of each data replica)
    # holds a non-zero sum
    ve_total = all_reduce(ve_sum, mesh, axis)
    if data_axis is not None:
        ve_total = all_reduce(ve_total, mesh, data_axis)
    # per-layer KLs live on their stage, replicated over data: the sum
    # over stages counts each once
    KL = all_reduce(sum((layer.KL() for layer in views), zero), mesh, axis)
    if final is not None:
        # the replicated head: its KL enters once, outside the stage sum
        KL = KL + final.KL()
    return ve_total * (model.num_data / B) - KL


def make_pp_train_step(optimizer, mesh, axis: str = "stage",
                       n_micro: Optional[int] = None,
                       data_axis: Optional[str] = None,
                       batch_size: Optional[int] = None):
    """Step ``step(model, X, Y, seed=None, zs=None) -> loss``: one Adam
    update of ``optimizer``'s parameters in place on -(log prior +
    :func:`pp_elbo`) of the batch (X, Y), under the gradient rule.  Build
    ``optimizer`` over the model the step trains: on a placed model each
    rank updates only its own stage's layers (and the replicated leaves)
    and keeps Adam state for them only."""
    return make_sharded_train_step(
        lambda model, X, Y, seed, zs: pp_elbo(
            model, X, Y, seed, mesh, axis, n_micro, data_axis, batch_size,
            zs),
        _stage_params, optimizer, mesh, axis,
        (data_axis,) if data_axis else ())
