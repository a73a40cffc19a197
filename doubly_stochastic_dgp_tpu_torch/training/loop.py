"""Training loop: on-device minibatches, the Adam step, ``fit`` and the
regression metrics.

Counterpart of ``doubly_stochastic_dgp_tpu/training/loop.py``
(``make_sgd_train_step``, ``fit``, ``evaluate_regression``).  PyTorch runs
eagerly, so there is no program to compile: a step is one forward and one
backward through the model and one optimizer update.  Minibatch indices
are drawn with replacement on the model's device from a
``torch.Generator`` there, and the batch is gathered there, so no data
cross to the host.  Random streams differ from the JAX package's; the
step takes explicit ``idx`` and ``zs`` to pin them.

Not ported yet (``fit`` raises): the natural-gradient steps (ROADMAP A11),
checkpoints, the reject-nonfinite guard (ROADMAP A7) and training the
models with a full-batch bound (the collapsed family: the psi2 backward
kernel, ROADMAP B5, and the guard, which the JAX ``fit`` turns on for
them).
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..serving import derive_seed
from ..utils.params import log_prior
from .optim import masked_optimizer

__all__ = ["check_minibatchable", "make_sgd_train_step", "fit",
           "evaluate_regression"]


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


def make_sgd_train_step(optimizer, batch_size: Optional[int] = None):
    """Step ``step(model, generator=None, idx=None, zs=None) -> loss``:
    one Adam update of ``model`` in place on the negative ELBO of a
    minibatch; returns the loss as a 0-dim tensor on the device (no host
    sync).

    Without ``idx``, ``batch_size`` indices (when it is below the number
    of stored rows) are drawn uniformly with replacement from
    ``generator``, which then also draws the samples unless ``zs`` (one
    array per layer) fixes them."""

    def step(model, generator=None, idx=None, zs=None):
        check_minibatchable(model, batch_size)
        X, Y = model.X_data, model.Y_data
        N = X.shape[0]
        if idx is None and batch_size is not None and batch_size < N:
            idx = torch.randint(0, N, (batch_size,), generator=generator,
                                device=X.device)
        if idx is not None:
            idx = torch.as_tensor(idx, device=X.device)
            X, Y = X[idx], Y[idx]
        optimizer.zero_grad(set_to_none=True)
        loss = _objective(model, X, Y, generator, zs)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def fit(model, iterations: int, learning_rate: float = 0.01,
        batch_size: Optional[int] = None, seed: int = 0,
        natgrad_gamma: Optional[float] = None, callbacks: Sequence = (),
        log_every: int = 100, scan_steps: Optional[int] = None,
        ckpt_dir: Optional[str] = None,
        reject_nonfinite: Optional[bool] = None):
    """Train ``model`` in place with Adam; returns (model, history).

    Steps run in chunks of ``scan_steps`` (default min(10, log_every)),
    whole chunks as in the JAX ``fit``; the losses stay on the device
    until a chunk that ends on a ``log_every`` boundary (or the last one),
    where the history gets {"iter", "loss" (the chunk's mean),
    "iters_per_sec", "elapsed"} and ``callbacks`` are called as
    cb(step, model, loss, stats).  The minibatches and samples come from
    one ``torch.Generator`` on the model's device seeded with ``seed``.

    ``natgrad_gamma``, ``ckpt_dir`` and ``reject_nonfinite=True`` are not
    ported yet and raise, and so does a model with a full-batch bound
    (after ``check_minibatchable``)."""
    check_minibatchable(model, batch_size)
    if model.full_batch_bound:
        raise NotImplementedError(
            f"fit({type(model).__name__}): training a full-batch-bound "
            f"model needs the psi2 backward kernel (ROADMAP B5) and the "
            f"reject-nonfinite guard that the JAX fit turns on for such "
            f"models (ROADMAP A7, guarded_scan); neither is ported yet")
    if natgrad_gamma is not None:
        raise NotImplementedError(
            "fit(natgrad_gamma=...): natural-gradient steps are not ported "
            "yet (ROADMAP A11)")
    if ckpt_dir is not None:
        raise NotImplementedError(
            "fit(ckpt_dir=...): checkpoints are not ported yet (ROADMAP A7, "
            "training/checkpoint.py)")
    if reject_nonfinite:
        raise NotImplementedError(
            "fit(reject_nonfinite=True): the trajectory guard is not ported "
            "yet (ROADMAP A7, guarded_scan)")
    chunk = max(1, min(10, log_every) if scan_steps is None else scan_steps)
    step = make_sgd_train_step(masked_optimizer(model, learning_rate),
                               batch_size)
    generator = torch.Generator(device=model.X_data.device)
    generator.manual_seed(seed)

    history = []
    t0 = time.perf_counter()
    last_t, last_i, done = t0, 0, 0
    while done < iterations:
        losses = [step(model, generator=generator) for _ in range(chunk)]
        done += chunk
        if done % log_every < chunk or done >= iterations:
            loss = float(torch.stack(losses).mean())
            now = time.perf_counter()
            rate = (done - last_i) / max(now - last_t, 1e-9)
            last_t, last_i = now, done
            stats = {"iter": done, "loss": loss, "iters_per_sec": rate,
                     "elapsed": now - t0}
            history.append(stats)
            for cb in callbacks:
                cb(done, model, loss, stats)
    return model, history


def evaluate_regression(model, Xs, Ys, Y_std, S: int = 100,
                        batch_size: int = 1000, seed: int = 0):
    """Test RMSE and log-likelihood with the definitions of the reference
    harness (run_regression.py:109-123): S-sample predictive moments in
    row batches, de-normalized by Y_std; the loglik is the logsumexp of
    the sample mixture's log densities (higher is better) and nll its
    negative.  Chunk ``mb`` draws from a generator seeded with
    ``derive_seed(seed, mb)``."""
    from scipy.special import logsumexp
    from scipy.stats import norm

    Xs = np.asarray(Xs)
    Ys = np.asarray(Ys)
    means, vars_ = [], []
    for mb in range(-(-len(Xs) // batch_size)):
        g = torch.Generator(device=model.X_data.device)
        g.manual_seed(derive_seed(seed, mb))
        m, v = model.predict_y(Xs[mb * batch_size:(mb + 1) * batch_size],
                               S=S, generator=g)
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
