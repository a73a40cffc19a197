"""Training loop: on-device minibatches, the Adam step, the reject-nonfinite
guard, ``fit`` with checkpoints, and the regression and classification
metrics.

Counterpart of ``doubly_stochastic_dgp_tpu/training/loop.py``
(``make_sgd_train_step``, ``guarded_scan``, ``make_scan_train_step``,
``make_natgrad_adam_step``, ``fit``, ``fit_dp``, ``evaluate_regression``,
``evaluate_classification``).  A step is one forward, gradients as values
(``torch.autograd.grad``) and one Adam update in place; the alternating
step adds a natural-gradient step on chosen layers' (q_mu, q_sqrt) before
it.  A chunk
of steps (the JAX ``lax.scan``) is, on a CUDA tensor, one captured CUDA
graph replayed per chunk (``graphs.CapturedCall``), with no host sync
inside it; on the CPU, and on the card inside ``graphs.eager_on_card()``,
the same code runs eagerly.  Minibatch indices are drawn with replacement
on the model's device from a ``torch.Generator`` there, and the batch is
gathered there; a graphed chunk's draws are made before each replay, in
the eager order, into buffers the graph reads (``graphs.DrawTape``), so
it takes the eager chunk's steps.  Random streams differ from the JAX
package's; the step takes explicit ``idx`` and ``zs`` to pin them.

The guard (:func:`guarded_scan`) selects the next state on the device
with ``torch.where``, as the JAX body does: nothing is read on the host,
and a rejected candidate is never installed.

``fit(ckpt_dir=...)`` saves and resumes (``training/checkpoint.py``).
``fit_dp`` is ``fit`` over a mesh of ranks (``parallel/``).
"""

from __future__ import annotations

import time
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from ..graphs import CapturedCall, DrawTape, graphs_enabled, randint
from ..serving import derive_seed
from ..tracing import span
from ..utils.params import log_prior
from .natgrad import natural_step
from .optim import (copy_state, freeze_q_params, make_train_step,
                    masked_optimizer, value_and_grads)

__all__ = ["check_minibatchable", "make_sgd_train_step", "guarded_scan",
           "make_scan_train_step", "make_natgrad_adam_step", "fit",
           "fit_dp", "evaluate_regression", "evaluate_classification"]

# The guard's trust scale: halved on a rejected step, down to 2^-12, and
# recovered by 2^(1/16) on an accepted one, up to exactly 1.0 (clamped by
# min, so a trajectory that is never rejected applies its updates scaled by
# exactly 1.0: the same bits).  On a deterministic full-batch objective a
# plain skip-and-retry would replay the same non-finite step for ever; the
# smaller scaled update from the rolled-back state is the way out.
_GUARD_SCALE_MIN = 2.0 ** -12
_GUARD_SCALE_RECOVER = 2.0 ** (1.0 / 16.0)
_GUARD_MIN_CHUNK = 8


def _objective(model, X, Y, generator, zs):
    # MAP objective: the parameters' log-priors join the bound (the DGP
    # has none, so log_prior is 0), as in GPflow 1.x's Model.objective
    return -(model.elbo(X, Y, generator=generator, zs=zs) + log_prior(model))


def check_minibatchable(model, batch_size):
    """Raise when a minibatch size is given for a model whose bound is
    evaluated on the whole stored training set (``full_batch_bound``: the
    collapsed family).  Its ``elbo(X, Y)`` ignores the batch, so every
    "minibatch" step would silently cost a full-batch step."""
    if batch_size is not None and model.full_batch_bound:
        raise ValueError(
            f"batch_size={batch_size} was requested, but "
            f"{type(model).__name__}'s objective is a full-batch bound (it "
            f"is evaluated on the entire stored training set and is not a "
            f"sum of per-datum terms); drop batch_size= or use a "
            f"minibatchable model (DGP)")


def _minibatch(model, batch_size, generator, idx=None):
    """(X, Y) of a minibatch: the rows ``idx`` if given, else
    ``batch_size`` rows (when below the number of stored rows) drawn
    uniformly with replacement from ``generator``, else every row."""
    check_minibatchable(model, batch_size)
    X, Y = model.X_data, model.Y_data
    N = X.shape[0]
    if idx is None and batch_size is not None and batch_size < N:
        idx = randint(N, (batch_size,), generator, X.device)
    if idx is not None:
        idx = torch.as_tensor(idx, device=X.device)
        X, Y = X[idx], Y[idx]
    return X, Y


def _minibatch_loss(model, batch_size, generator, idx=None, zs=None):
    """The objective on a :func:`_minibatch`; ``generator`` draws the
    samples unless ``zs`` fixes them."""
    X, Y = _minibatch(model, batch_size, generator, idx)
    return _objective(model, X, Y, generator, zs)


def make_sgd_train_step(optimizer, batch_size: Optional[int] = None):
    """Step ``step(model, generator=None, idx=None, zs=None) -> loss``:
    one Adam update of ``model`` in place on the negative ELBO of a
    minibatch; returns the loss as a 0-dim tensor on the device (no host
    sync).

    Without ``idx``, ``batch_size`` indices (when it is below the number
    of stored rows) are drawn uniformly with replacement from
    ``generator``, which then also draws the samples unless ``zs`` (one
    array per layer) fixes them."""

    def loss(model, generator=None, idx=None, zs=None):
        return _minibatch_loss(model, batch_size, generator, idx, zs)

    return make_train_step(loss, optimizer)


def make_natgrad_adam_step(optimizer, gamma: float,
                           ng_layers: Sequence[int] = (-1,),
                           batch_size: Optional[int] = None):
    """Step ``step(model, generator=None, idx=None, zs=None) -> loss``: one
    iteration of the alternating loop (the JAX ``make_natgrad_adam_step``
    body): one minibatch, a natural-gradient step of size ``gamma`` on the
    (q_mu, q_sqrt) of ``model.layers[i]`` for i in ``ng_layers`` from the
    objective's gradient at one set of samples, then an Adam update of
    ``optimizer``'s parameters (built with ``freeze=freeze_q_params(...)``,
    so it leaves those out) from a second gradient at fresh samples; both
    on the MAP objective.  Returns the second evaluation's loss, a 0-dim
    tensor (no host read).

    The draws come from ``generator`` in this order: the minibatch
    indices (unless ``idx`` is given), the natural step's normals, Adam's
    normals; ``zs`` = (the natural step's, Adam's) fixes both sets.
    ``step.rejected`` (a 0-dim int64 tensor on the device) counts the
    natural updates rejected for a non-finite result, one a layer and
    output dimension."""
    rejected = torch.zeros_like(optimizer.state.count)
    adam = make_train_step(_objective, optimizer)

    @torch.no_grad()
    def step(model, generator=None, idx=None, zs=None):
        X, Y = _minibatch(model, batch_size, generator, idx)
        z_nat, z_adam = (None, None) if zs is None else zs
        with torch.enable_grad():
            natural_step(model, _objective(model, X, Y, generator, z_nat),
                         ng_layers, gamma, rejected)
        return adam(model, X, Y, generator, z_adam)

    step.rejected = rejected
    return step


def _all_finite(loss, tensors):
    """0-dim bool tensor: ``loss`` and every entry of ``tensors`` finite."""
    flat = torch.cat([loss.reshape(1)] + [t.reshape(-1) for t in tensors])
    return torch.isfinite(flat).all()


def _select_(ok, dst, a, b):
    """dst[i] <- where(ok, a[i], b[i]) for lists of tensors."""
    torch._foreach_copy_(dst, [torch.where(ok, x, y) for x, y in zip(a, b)])


def _flat_state(state):
    return [state.count] + state.mu + state.nu


def _select_state_(ok, dst, a, b):
    _select_(ok, _flat_state(dst), _flat_state(a), _flat_state(b))


def _copy_state_(dst, src):
    torch._foreach_copy_(_flat_state(dst), _flat_state(src))


@torch.no_grad()
def guarded_scan(loss_and_grads, loss_only, tx, params, opt_state, keys):
    """The reject-nonfinite optimization core: the JAX ``guarded_scan``
    with its semantics and its ``where``-selects, a chunk of ``len(keys) -
    1`` steps, with no host read.

    ``params`` is the list of parameter tensors, updated in place;
    ``loss_and_grads(params, key) -> (loss, grads)`` and
    ``loss_only(params, key) -> loss`` evaluate the objective at their
    current values (``grads`` in the order of ``params``); ``tx`` yields
    the update as a value and advances its state in place
    (``tx.update(grads, state) -> updates``, :class:`~.optim.Adam`);
    ``opt_state`` is updated in place; the last key drives the
    verification forward after the chunk.  Returns (opt_state, nanmean of
    the reported losses, number of rollbacks: rejected steps and a failed
    verification), the last two as 0-dim tensors on the device.

    A step evaluates loss and gradients at the current state, scales the
    Adam update by the trust scale and forms the candidate; it is accepted
    iff the loss, every gradient and every candidate parameter are finite.
    Accept: the state becomes the candidate, and ``prev`` the state before
    this update.  Reject: the state goes back to ``prev`` (one step
    delayed: this undoes the previous accepted update, the one that walked
    into the non-finite region), ``prev`` stays.  The scale goes to
    min(1, scale 2^(1/16)) on accept and max(2^-12, scale / 2) on reject,
    in the parameters' dtype.  A step reports its loss if finite, else the
    last finite one.  After the chunk one more forward: if it is not
    finite, the state goes back to ``prev``, so a chunk never hands on a
    state that was not verified."""
    like = params[0]
    scale = torch.ones((), dtype=like.dtype, device=like.device)
    last_loss = torch.full((), float("nan"), dtype=like.dtype,
                           device=like.device)
    rejected = torch.zeros((), dtype=torch.int64, device=like.device)
    prev = [p.clone() for p in params]
    prev_opt = copy_state(opt_state)
    losses = []
    for key in keys[:-1]:
        with torch.enable_grad():
            loss, grads = loss_and_grads(params, key)
        loss = loss.detach()
        before = copy_state(opt_state)
        updates = tx.update(grads, opt_state)
        torch._foreach_mul_(updates, scale)
        cand = torch._foreach_add(params, updates)
        ok = _all_finite(loss, list(grads) + list(cand))
        # accept: params <- cand, prev <- params; reject: params <- prev
        # (Adam's state alike)
        new_prev = [torch.where(ok, p, q) for p, q in zip(params, prev)]
        _select_(ok, params, cand, prev)
        torch._foreach_copy_(prev, new_prev)
        _select_state_(ok, opt_state, opt_state, prev_opt)
        _select_state_(ok, prev_opt, before, prev_opt)
        scale = torch.where(ok,
                            torch.clamp(scale * _GUARD_SCALE_RECOVER, max=1.0),
                            torch.clamp(scale * 0.5, min=_GUARD_SCALE_MIN))
        rejected += ~ok
        last_loss = torch.where(torch.isfinite(loss), loss.to(like.dtype),
                                last_loss)
        losses.append(last_loss)
    ok = torch.isfinite(loss_only(params, keys[-1]))
    _select_(ok, params, params, prev)
    _select_state_(ok, opt_state, opt_state, prev_opt)
    rejected += ~ok
    return opt_state, torch.nanmean(torch.stack(losses)), rejected


def make_scan_train_step(optimizer, batch_size: Optional[int] = None,
                         inner_steps: int = 10,
                         reject_nonfinite: bool = False, step=None):
    """Chunk ``chunk(model, generator=None) -> loss``: ``inner_steps``
    Adam steps of ``model`` in place, and their mean loss (a 0-dim tensor,
    no host sync).  ``step``: the step to take instead, one of
    :func:`make_natgrad_adam_step` (the alternating loop's chunk, the JAX
    ``inner_steps``; not with the guard); ``chunk.rejected`` is then its
    ``step.rejected``.

    On a CUDA tensor the chunk is captured as one CUDA graph at its first
    call and replayed at every call (outside ``graphs.eager_on_card()``):
    the capture's warm-up runs one chunk eagerly from a snapshot of the
    model's parameters, the Adam state, the rejection count and the
    generator, and restores it, so it takes no step.  Before each replay
    the chunk's draws (per step the minibatch indices, then each layer's
    normals, in the step's order) are made from ``generator`` into the
    buffers the graph reads.  A capture that fails raises.

    ``reject_nonfinite=True`` bounds the trajectory with
    :func:`guarded_scan`: a step whose loss, gradient or candidate is not
    finite rolls back to the state before the previous update and halves
    a trust scale; the chunk ends with a verification forward, and its
    loss is the nanmean of the last finite losses.  A chunk that is never
    rejected takes exactly the unguarded steps.  The scale starts at 1.0
    in every chunk, so its halving works only within a chunk: use
    ``inner_steps`` >= 8 with the guard (``fit`` does).  The chunk's
    rejections are added to ``chunk.rejected``, a 0-dim tensor on the
    model's device."""
    if step is not None and reject_nonfinite:
        raise ValueError("the guard does not apply to a given step (the "
                         "alternating loop has its own reject net)")
    params = optimizer.params
    if step is None:
        kind = "guarded" if reject_nonfinite else "plain"
        step = make_sgd_train_step(optimizer, batch_size)
        # the chunk's rejection count, also ``chunk.rejected``; the
        # closures below do not refer to the chunk, so a chunk and its
        # captured graph are freed when the last reference goes, not by a
        # cyclic collection
        rejected_total = torch.zeros_like(optimizer.state.count)
    else:
        kind = "natural-gradient and Adam"
        rejected_total = step.rejected

    def body(model, generator):
        if not reject_nonfinite:
            return torch.stack([step(model, generator)
                                for _ in range(inner_steps)]).mean()
        _, loss, rejected = guarded_scan(
            lambda p, k: value_and_grads(
                lambda: _minibatch_loss(model, batch_size, generator),
                params),
            lambda p, k: _minibatch_loss(model, batch_size, generator),
            optimizer, params, optimizer.state, range(inner_steps + 1))
        rejected_total.add_(rejected)
        return loss

    return _Chunk(body, _chunk_capture(
        body, optimizer, rejected_total,
        f"{kind} training chunk of {inner_steps} steps"), rejected_total)


def _chunk_capture(body, optimizer, rejected_total, what):
    """``capture(model, generator) -> (tape, CapturedCall)``: the CUDA
    graph of ``body(model, tape)``, whose eager warm-up runs from a
    snapshot of the model's parameters, the Adam state, the rejection
    count and the generator, and restores it."""

    def capture(model, generator):
        tape = DrawTape(generator)
        # every parameter of the model: a natural step also writes those
        # the optimizer leaves out.  Detached: a clone that kept the
        # parameters' autograd nodes alive would pin them to this stream,
        # which the capture cannot join
        written = list(model.parameters())
        saved = ([p.detach().clone() for p in written],
                 copy_state(optimizer.state), rejected_total.clone(),
                 generator.get_state())

        def warmup():
            body(model, tape)
            with torch.no_grad():
                torch._foreach_copy_(written, saved[0])
                _copy_state_(optimizer.state, saved[1])
                rejected_total.copy_(saved[2])
            generator.set_state(saved[3])
            tape.freeze()

        return tape, CapturedCall(lambda: body(model, tape), warmup,
                                  f"{what} ({type(model).__name__})")

    return capture


class _Chunk:
    """The callable :func:`make_scan_train_step` returns: eager on the CPU
    (and inside ``graphs.eager_on_card()``, or when not ``graphable``),
    else the captured graph of its model, captured at the first call.
    ``graph`` is (model, tape, ``CapturedCall``) once captured;
    ``dispatch`` is 'graph' or 'eager', the way the last call went.

    Each call is a ``fit.chunk`` span (``tracing.py``), its trace id the
    call's index, with children ``fit.capture`` (the first call on the
    card), ``fit.draws`` (the tape's draws), ``fit.replay`` and
    ``fit.output`` (the loss's clone), or ``fit.eager``."""

    def __init__(self, body, capture, rejected, graphable=True):
        self._body, self._capture = body, capture
        self.rejected = rejected
        self.graphable = graphable
        self.graph = None
        self.dispatch = None
        self.calls = 0

    def __call__(self, model, generator=None):
        self.calls += 1
        with span("fit.chunk", trace=self.calls - 1):
            return self._call(model, generator)

    def _call(self, model, generator):
        if not (self.graphable and graphs_enabled(model.X_data.device)):
            self.dispatch = "eager"
            with span("fit.eager"):
                return self._body(model, generator)
        if generator is None:
            raise ValueError("a graphed chunk needs a generator")
        if self.graph is None or self.graph[0] is not model:
            with span("fit.capture"):
                self.graph = (model,) + self._capture(model, generator)
        _, tape, graph = self.graph
        with span("fit.draws"):
            tape.fill(generator)
        self.dispatch = "graph"
        with span("fit.replay"):
            loss = graph.replay()
        with span("fit.output"):
            return loss.clone()


class _Log:
    """The log events of :func:`fit` and :func:`fit_dp`: each a
    ``fit.log`` span (its trace id the chunk's index) holding
    ``fit.sync`` (the host's reads of the loss and, when ``guarded``, of
    the rejected count: its wait for the device) and ``fit.callbacks``;
    ``history`` holds each event's stats, with the chunk's dispatch when
    ``dispatch``."""

    def __init__(self, run_chunk, callbacks, done, guarded, dispatch=False):
        self.run_chunk, self.callbacks = run_chunk, callbacks
        self.guarded, self.dispatch = bool(guarded), dispatch
        self.history = []
        self.t0 = self.last_t = time.perf_counter()
        self.last_i = done

    def __call__(self, model, loss, done):
        with span("fit.log", trace=self.run_chunk.calls - 1):
            with span("fit.sync"):
                loss = float(loss)
                rejected = (int(self.run_chunk.rejected) if self.guarded
                            else None)
            now = time.perf_counter()
            rate = (done - self.last_i) / max(now - self.last_t, 1e-9)
            self.last_t, self.last_i = now, done
            stats = {"iter": done, "loss": loss, "iters_per_sec": rate,
                     "elapsed": now - self.t0}
            if self.dispatch:
                stats["dispatch"] = self.run_chunk.dispatch
            if rejected is not None:
                stats["rejected"] = rejected
            self.history.append(stats)
            with span("fit.callbacks"):
                for cb in self.callbacks:
                    cb(done, model, loss, stats)


def fit(model, iterations: int, learning_rate: float = 0.01,
        batch_size: Optional[int] = None, seed: int = 0,
        natgrad_gamma: Optional[float] = None,
        ng_layers: Sequence[int] = (-1,), callbacks: Sequence = (),
        log_every: int = 100, scan_steps: Optional[int] = None,
        ckpt_dir: Optional[str] = None, ckpt_every: Optional[int] = None,
        reject_nonfinite: Optional[bool] = None):
    """Train ``model`` in place with Adam, or with natural gradients and
    Adam in turns; returns (model, history).

    Steps run in chunks of ``scan_steps`` (default min(10, log_every)),
    whole chunks as in the JAX ``fit``, each a captured CUDA graph on the
    card (:func:`make_scan_train_step`); the losses stay on the device
    until a chunk that ends on a ``log_every`` boundary (or the last one),
    where the history gets {"iter", "loss" (the chunk's mean),
    "iters_per_sec", "elapsed"} and ``callbacks`` are called as
    cb(step, model, loss, stats).  The minibatches and samples come from
    one ``torch.Generator`` on the model's device seeded with ``seed``.
    Spans (``tracing.py``): ``fit.chunk`` for each chunk, ``fit.log`` at
    each log event, with ``fit.sync`` (the host's wait for the loss) and
    ``fit.callbacks``, and ``fit.checkpoint``; their trace id is the
    chunk's index in this call.

    ``reject_nonfinite`` bounds the trajectory with the rollback and
    trust-scale guard (:func:`make_scan_train_step`); the history then
    also counts the rejected steps so far ("rejected") and its loss is the
    chunk's nanmean.  The default ``None`` turns the guard on for models
    with a full-batch bound (the collapsed family), whose float32 bounds
    can sit one rounding away from an indefinite matrix; ``False`` forces
    the plain step.  With the guard on, a chunk below 8 steps is raised to
    8 with a warning.

    ``natgrad_gamma``: each iteration is the alternating loop of
    :func:`make_natgrad_adam_step`, a natural-gradient step of that size
    on the (q_mu, q_sqrt) of ``model.layers[i]`` for i in ``ng_layers``,
    then Adam on the other parameters (the Adam state holds only those).
    The guard is not applied on this path (the natural step has its own
    reject net); the history counts the natural updates rejected so far
    ("rejected", one a layer and output dimension).

    ``ckpt_dir``: resume from the latest ``ckpt_<step>.npz`` there, if
    any (the parameters, the Adam state, the generator's state and the
    rejection count, copied into the existing tensors), and save one
    after every chunk that ends on a ``ckpt_every`` boundary (default
    ``log_every``) and after the last, as the JAX ``fit`` does; a resumed
    fit continues the trajectory of an uninterrupted one."""
    check_minibatchable(model, batch_size)
    if reject_nonfinite is None:
        reject_nonfinite = bool(model.full_batch_bound)
    chunk = max(1, min(10, log_every) if scan_steps is None else scan_steps)
    if reject_nonfinite and chunk < _GUARD_MIN_CHUNK:
        # the trust scale starts at 1.0 in every chunk, so in a short chunk
        # a deterministic bound can replay the same accept, non-finite,
        # rollback cycle for ever; 8 steps let it shrink to 2^-7
        warnings.warn(
            f"reject_nonfinite guard: raising scan_steps from {chunk} to "
            f"{_GUARD_MIN_CHUNK} (the trust scale needs room within a "
            f"chunk; pass reject_nonfinite=False to keep scan_steps={chunk})")
        chunk = _GUARD_MIN_CHUNK
    if natgrad_gamma is not None:
        optimizer = masked_optimizer(
            model, learning_rate,
            freeze=freeze_q_params(ng_layers, len(model.layers)))
        run_chunk = make_scan_train_step(
            optimizer, batch_size, inner_steps=chunk,
            step=make_natgrad_adam_step(optimizer, natgrad_gamma, ng_layers,
                                        batch_size))
        reject_nonfinite = False
    else:
        optimizer = masked_optimizer(model, learning_rate)
        run_chunk = make_scan_train_step(
            optimizer, batch_size, inner_steps=chunk,
            reject_nonfinite=reject_nonfinite)
    generator = torch.Generator(device=model.X_data.device)
    generator.manual_seed(seed)

    done = 0
    if ckpt_dir is not None:
        from .checkpoint import restore_checkpoint
        _, resumed = restore_checkpoint(
            ckpt_dir, (model, optimizer.state, generator, run_chunk.rejected))
        if resumed is not None:
            done = int(resumed)
    ckpt_every = ckpt_every or log_every

    log = _Log(run_chunk, callbacks, done,
               reject_nonfinite or natgrad_gamma is not None)
    while done < iterations:
        loss = run_chunk(model, generator=generator)
        done += chunk
        if ckpt_dir is not None and (done % ckpt_every < chunk
                                     or done >= iterations):
            from .checkpoint import save_checkpoint
            with span("fit.checkpoint", trace=run_chunk.calls - 1):
                save_checkpoint(ckpt_dir, (model, optimizer.state,
                                           generator, run_chunk.rejected),
                                done)
        if done % log_every < chunk or done >= iterations:
            log(model, loss, done)
    return model, log.history


def fit_dp(model, mesh, iterations: int, learning_rate: float = 0.01,
           batch_size: Optional[int] = None, seed: int = 0,
           axis: str = "data", sample_axis: Optional[str] = None,
           callbacks: Sequence = (), log_every: int = 100,
           scan_steps: Optional[int] = None,
           ckpt_dir: Optional[str] = None,
           ckpt_every: Optional[int] = None,
           reject_nonfinite: Optional[bool] = None):
    """:func:`fit` over a mesh (``parallel/mesh.py``), called on every
    rank: broadcasts rank 0's parameters, splits the model's stored
    training rows over ``axis`` and trains in place with the scanned
    data-parallel step (``parallel.dp.make_dp_scan_train_step``); with
    ``sample_axis`` (a 2-D mesh) the data x sample step splits the MC
    samples too.  Returns (model, history); every rank ends with the same
    parameters.

    Rank d of the data axis draws from ``rank_generator(seed, d)`` for the
    whole run (a chunk's draws follow from the seed, the rank and the
    chunk's index, as the JAX key folds them): on a one-rank mesh that is
    ``fit``'s generator, and ``fit_dp`` takes ``fit``'s steps.  Chunks, logging, callbacks (called on every rank),
    spans and the guard are ``fit``'s; the guard is off by default
    (``reject_nonfinite=None`` means False here) and not applied to the
    data x sample step.  History entries add "dispatch": 'graph' (NCCL
    on the card: one captured CUDA graph a chunk, its all-reduces
    inside) or 'eager' (gloo, and the CPU).  ``ckpt_dir``: rank 0 saves
    the parameters, the Adam state, every rank's generator state and the
    rejection count; a later ``fit_dp`` on the same mesh resumes from the
    latest checkpoint, each rank with its own generator state.

    A model with a full-batch bound (the collapsed family) raises:
    ``parallel.collapsed`` has its data-parallel steps."""
    import torch.distributed as dist

    from ..parallel.dp import (make_dp_scan_train_step,
                               make_dp_sp_scan_train_step)
    from ..parallel.mesh import (all_reduce_sum_, axis_index, axis_size,
                                 rank_generator, replicate)

    check_minibatchable(model, batch_size)
    if model.full_batch_bound:
        # the generic data-parallel step optimizes the per-datum
        # E_log_p_Y - KL decomposition, which the collapsed bounds are not
        raise ValueError(
            f"{type(model).__name__}'s objective is a full-batch "
            f"collapsed bound: fit_dp's generic data-parallel step "
            f"would silently optimize the uncollapsed per-datum "
            f"decomposition instead.  Use the dedicated collapsed DP "
            f"machinery: parallel.collapsed.collapsed_shard/"
            f"damianou_shard + make_dp_collapsed_train_step/"
            f"make_dp_damianou_train_step (the all-reduced psi-moment "
            f"algebra), or train on one device with fit().")
    if reject_nonfinite is None:
        reject_nonfinite = False
    n_data = axis_size(mesh, axis)
    N = int(model.X_data.shape[0])
    if N % n_data != 0:
        raise ValueError(
            f"training rows N={N} must divide the '{axis}' mesh axis "
            f"({n_data}); pad or trim the dataset")
    chunk = max(1, min(10, log_every) if scan_steps is None else scan_steps)
    if reject_nonfinite and chunk < _GUARD_MIN_CHUNK:
        warnings.warn(
            f"reject_nonfinite guard: raising scan_steps from {chunk} to "
            f"{_GUARD_MIN_CHUNK} (the trust scale needs room within a "
            f"chunk; pass reject_nonfinite=False to keep scan_steps={chunk})")
        chunk = _GUARD_MIN_CHUNK
    if reject_nonfinite and sample_axis is not None:
        warnings.warn(
            "reject_nonfinite guard is not implemented for the composed "
            "data x sample step; training unguarded "
            "(pass reject_nonfinite=False to silence)")
        reject_nonfinite = False

    replicate(model, mesh)
    optimizer = masked_optimizer(model, learning_rate)
    if sample_axis is None:
        run_chunk = make_dp_scan_train_step(
            optimizer, mesh, axis=axis, batch_size=batch_size,
            inner_steps=chunk, reject_nonfinite=reject_nonfinite)
    else:
        run_chunk = make_dp_sp_scan_train_step(
            optimizer, mesh, data_axis=axis, sample_axis=sample_axis,
            batch_size=batch_size, inner_steps=chunk)
    device = model.X_data.device
    generator = rank_generator(seed, axis_index(mesh, axis), device)
    rank, world = dist.get_rank(), mesh.size()
    own = generator.get_state()

    def generator_states():
        # every rank's generator state, gathered: a zero-filled buffer
        # with this rank's row, summed over the mesh
        buf = torch.zeros((world, own.numel()), dtype=torch.int64,
                          device=device)
        buf[rank] = generator.get_state().to(device=device,
                                             dtype=torch.int64)
        return all_reduce_sum_([buf], mesh)[0].to(torch.uint8).cpu()

    done = 0
    if ckpt_dir is not None:
        from .checkpoint import restore_checkpoint
        states = torch.zeros((world, own.numel()), dtype=torch.uint8)
        _, resumed = restore_checkpoint(
            ckpt_dir, (model, optimizer.state, states, run_chunk.rejected))
        if resumed is not None:
            done = int(resumed)
            generator.set_state(states[rank].clone())
    ckpt_every = ckpt_every or log_every

    log = _Log(run_chunk, callbacks, done, reject_nonfinite, dispatch=True)
    while done < iterations:
        loss = run_chunk(model, generator=generator)
        done += chunk
        if ckpt_dir is not None and (done % ckpt_every < chunk
                                     or done >= iterations):
            with span("fit.checkpoint", trace=run_chunk.calls - 1):
                states = generator_states()
                if rank == 0:
                    from .checkpoint import save_checkpoint
                    save_checkpoint(ckpt_dir, (model, optimizer.state,
                                               states, run_chunk.rejected),
                                    done)
        if done % log_every < chunk or done >= iterations:
            log(model, loss, done)
    return model, log.history


def _chunk_draws(model, seed, mb, batch_size, zs):
    """(generator, zs) of row chunk ``mb`` of an evaluation: a generator
    seeded with ``derive_seed(seed, mb)``, or the chunk's rows of ``zs``
    (a layer's (S, 1, D) broadcast as it is)."""
    if zs is not None:
        rows = slice(mb * batch_size, (mb + 1) * batch_size)
        return None, [z if z.shape[-2] == 1 else z[..., rows, :]
                      for z in zs]
    g = torch.Generator(device=model.X_data.device)
    g.manual_seed(derive_seed(seed, mb))
    return g, None


def evaluate_regression(model, Xs, Ys, Y_std, S: int = 100,
                        batch_size: int = 1000, seed: int = 0, zs=None):
    """Test RMSE and log-likelihood with the definitions of the reference
    harness (run_regression.py:109-123): S-sample predictive moments in
    row batches, de-normalized by Y_std; the loglik is the logsumexp of
    the sample mixture's log densities (higher is better) and nll its
    negative.  Chunk ``mb`` draws from a generator seeded with
    ``derive_seed(seed, mb)``; ``zs`` (one (S, N or 1, D_l) array a layer)
    pins the draws instead."""
    from scipy.special import logsumexp
    from scipy.stats import norm

    Xs = np.asarray(Xs)
    Ys = np.asarray(Ys)
    means, vars_ = [], []
    for mb in range(-(-len(Xs) // batch_size)):
        g, z = _chunk_draws(model, seed, mb, batch_size, zs)
        m, v = model.predict_y(Xs[mb * batch_size:(mb + 1) * batch_size],
                               S=S, generator=g, zs=z)
        m, v = m.double().cpu().numpy(), v.double().cpu().numpy()
        if m.ndim == 2:   # models that squeeze the sample axis
            m, v = m[None], v[None]
        means.append(m)
        vars_.append(v)
    mean_SND = np.concatenate(means, 1)
    var_SND = np.concatenate(vars_, 1)
    mean_ND = np.average(mean_SND, 0)

    test_err = np.average(Y_std * np.mean((Ys - mean_ND) ** 2.0) ** 0.5)
    # the mixture divisor is the number of sample components kept
    S_kept = mean_SND.shape[0]
    test_loglik_ND = logsumexp(
        norm.logpdf(Ys * Y_std, mean_SND * Y_std, var_SND ** 0.5 * Y_std),
        0, b=1 / float(S_kept))
    test_loglik = np.average(test_loglik_ND)
    return {"rmse": float(test_err), "nll": float(-test_loglik),
            "loglik": float(test_loglik)}


def evaluate_classification(model, Xs, Ys, S: int = 100,
                            batch_size: int = 1000, seed: int = 0, zs=None):
    """Test accuracy and mean log predictive probability of a classifier,
    with the definitions of the reference MNIST notebook (cell 11): the
    class probabilities are the S-sample mean of the ``predict_y`` means
    (the robust-max ``MultiClass`` likelihood returns class
    probabilities), the accuracy is the argmax match, and the loglik is
    log p(true class) clamped at 1e-12.  ``Ys`` holds integer class
    labels, (N, 1).  Chunk ``mb`` draws from a generator seeded with
    ``derive_seed(seed, mb)``; ``zs`` pins the draws instead."""
    Xs = np.asarray(Xs)
    Ys = np.asarray(Ys)
    correct, lls = 0, []
    for mb in range(-(-len(Xs) // batch_size)):
        g, z = _chunk_draws(model, seed, mb, batch_size, zs)
        y = Ys[mb * batch_size:(mb + 1) * batch_size]
        m, _ = model.predict_y(Xs[mb * batch_size:(mb + 1) * batch_size],
                               S=S, generator=g, zs=z)
        m = m.double().cpu().numpy()
        if m.ndim == 2:   # models that squeeze the sample axis
            m = m[None]
        probs = m.mean(0)
        correct += int((probs.argmax(1) == y[:, 0]).sum())
        lls.append(np.log(np.maximum(
            probs[np.arange(len(y)), y[:, 0].astype(int)], 1e-12)))
    loglik = float(np.concatenate(lls).mean())
    return {"accuracy": correct / len(Xs), "loglik": loglik,
            "nll": -loglik}
