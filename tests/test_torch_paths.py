"""PyTorch port: the serving and training paths of a 3-layer DGP (also
under the default ``Config()``, ``solve_mode='solve'``, with its
full-covariance predictions and ``remat``), and the bound and predictions
of the collapsed DGPs (DGPDamianou, DGPCollapsed, also their
full-covariance propagation), against the JAX package in float64 on the
CPU, the port's server and ``fit`` semantics (with checkpoints and
resume), the reject-nonfinite guard against the JAX ``guarded_scan`` and
``fit``, and a training chunk (plain, and guarded on DGPCollapsed) and a
live and a cached request with no host read (what a CUDA graph captures
on the card); the quadrature DGP (``DGPQuad``), the heteroscedastic DGP
(``DGPHeteroscedastic``) and the input-propagation stack
(``init_layers_input_prop``), each carried over by
``load_reference_state``: bound or ELBO and gradients, predictions, the
cached model, and a chunk and requests with no host read; the
alternating NatGrad + Adam step against a JAX oracle, ``fit(natgrad_gamma=)``
with its checkpoint and resume, the two gamma = 1 identities (SVGP against
SGPR, DGPQuad against DGPCollapsed), ``lbfgs_minimize`` at the JAX
optimum, and ``precompute`` of both collapsed DGPs against JAX's; the MCMC
models (``SGPMCLayer`` on its three branches, ``GPMCLayer`` and
``DGPHeinonen``: values and gradients, their ``precompute`` and
``load_reference_state``), ``DynamicPredictor`` and the exported
``predict_y`` program round trip; and on gloo ranks the data-parallel
steps, ``fit_dp`` (resume, a data x sample mesh, one rank against
``fit`` bit for bit), predictions and evaluation against the port's
single-process functions on the same rows and draws.

The model (D=5 narrowing to a hidden width of 3, so a PCA Linear mean
function is exercised; M=20) is built in JAX with ``use_pallas=True``
and a randomised posterior, and carried over with
``load_reference_state``.  Random streams differ between the packages,
so the parity runs through fixed draws ``zs`` and fixed minibatch
indices.  The JAX objective is assembled from the package's public
pieces (``propagate``, ``variational_expectations``, ``KL``, the
num_data / batch scale, ``log_prior``).  One test item that names the
failing case in every assertion message."""

import contextlib
import copy
import io
import json
import os
import tempfile
import warnings
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from jax.scipy.special import logsumexp
from numpy.testing import assert_allclose

import doubly_stochastic_dgp_tpu as dsd
from doubly_stochastic_dgp_tpu.config import temp_config
from doubly_stochastic_dgp_tpu.data.datasets import (
    load_mnist_npz as jax_load_mnist_npz)
from doubly_stochastic_dgp_tpu.models import initializations as jinit
from doubly_stochastic_dgp_tpu.models.layers import SGPRLayer as JSGPRLayer
from doubly_stochastic_dgp_tpu.training.loop import (
    evaluate_classification as jax_evaluate_classification,
    evaluate_regression as jax_evaluate_regression, fit as jax_fit,
    guarded_scan as jax_guarded_scan)
from doubly_stochastic_dgp_tpu.training import monitor as jmonitor
from doubly_stochastic_dgp_tpu.training.natgrad import (
    natgrad_update as jax_natgrad_update)
from doubly_stochastic_dgp_tpu.training.optim import (
    freeze_q_params as jax_freeze_q_params,
    lbfgs_minimize as jax_lbfgs_minimize, masked_optimizer)
from doubly_stochastic_dgp_tpu.utils.modules import log_prior, trainable_mask
import doubly_stochastic_dgp_tpu_torch as port
from doubly_stochastic_dgp_tpu_torch.convert import _torch_key
from doubly_stochastic_dgp_tpu_torch.graphs import no_host_reads
from doubly_stochastic_dgp_tpu_torch.models import initializations as tinit
from doubly_stochastic_dgp_tpu_torch.ops.cuda.conditional import (
    fused_conditional)
from doubly_stochastic_dgp_tpu_torch.ops.cuda.psi2 import psi2_core
from doubly_stochastic_dgp_tpu_torch.training.checkpoint import latest_step
from doubly_stochastic_dgp_tpu_torch.training.loop import (
    guarded_scan, make_scan_train_step, make_sgd_train_step)
from doubly_stochastic_dgp_tpu_torch.training.monitor import (
    FullElboCallback, JsonlLogger, PrintTimings)
from doubly_stochastic_dgp_tpu_torch.training.optim import (
    Adam, AdamState, freeze_q_params as port_freeze_q_params,
    masked_optimizer as port_masked_optimizer)
from doubly_stochastic_dgp_tpu_torch.utils.params import Param

RTOL, ATOL = 1e-8, 1e-10
# the quadrature, heteroscedastic and input-propagation cases hold values
# to 1e-10 relative (gradients to RTOL)
VALUE_RTOL = 1e-10
S, N, D, M, H = 4, 30, 5, 20, 3
BATCH, LR, STEPS = 30, 0.01, 20
# 20 Adam steps in float64: optax and torch.optim.Adam evaluate the same
# update in a different order, and Adam's normalization m / sqrt(v)
# amplifies the rounding of near-zero gradients; measured maximum
# relative deviation 1.5e-14 (loss) and 7.1e-11 (parameters)
TRAJ_RTOL, TRAJ_ATOL = 1e-6, 1e-9


# the numerics the paths are built with, in both packages, unless a case
# says otherwise (the default Config() is solve_mode='solve', use_pallas
# False, jitter 1e-6, as the JAX default config)
FUSED = dict(use_pallas=True, solve_mode="inverse", jitter=1e-6)


def _jax_model(rng, X, Y, numerics=FUSED, randomise=(0, 1, 2)):
    """The 3-layer JAX DGP with the posterior of the layers ``randomise``
    moved off its initialization."""
    Z = X[:M]
    with temp_config(**numerics):
        kernels = [dsd.RBF.make(D) + dsd.White.make(D, variance=2e-6),
                   dsd.RBF.make(H, lengthscales=1.3)
                   + dsd.White.make(H, variance=2e-6),
                   dsd.RBF.make(H, variance=0.9)]
        model = dsd.DGP.build(X, Y, Z, kernels, dsd.Gaussian.make(0.05))
    layers = []
    for l, layer in enumerate(model.layers):
        if l not in randomise:
            layers.append(layer)
            continue
        Mi, Do = layer.q_mu.value.shape
        q_sqrt = np.tril(rng.randn(Do, Mi, Mi) * 0.2) + 0.3 * np.eye(Mi)
        layers.append(layer.replace(
            q_mu=layer.q_mu.with_value(rng.randn(Mi, Do)),
            q_sqrt=layer.q_sqrt.with_value(q_sqrt)))
    return model.replace(layers=layers)


def _port_model(X, Y, jmodel, cfg=port.Config(**FUSED)):
    kernels = [port.RBF(D) + port.White(D), port.RBF(H) + port.White(H),
               port.RBF(H)]
    model = port.DGP.build(X, Y, X[:M], kernels, port.Gaussian(1.0),
                           num_samples=S, config=cfg, device="cpu")
    return port.load_reference_state(model, _flat(jmodel))


def _flat(tree):
    """{port parameter name: numpy array} of a JAX pytree."""
    return {_torch_key(jax.tree_util.keystr(p)): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_loss(model, X, Y, zs):
    """The negative ELBO plus log-prior from the JAX package's public
    pieces, at fixed draws."""
    _, Fmeans, Fvars = model.propagate(X, S=S, zs=zs)
    var_exp = model.likelihood.variational_expectations(Fmeans[-1],
                                                        Fvars[-1], Y)
    L = jnp.sum(jnp.mean(var_exp, axis=0))
    KL = sum(layer.KL() for layer in model.layers)
    return -(L * (model.num_data / X.shape[0]) - KL + log_prior(model))


def _draws(rng, n):
    idx = rng.randint(0, n, BATCH)
    return idx, [rng.randn(S, BATCH, d) for d in (H, H, 1)]


_jax_loss_and_grads = jax.jit(jax.value_and_grad(_jax_loss))


def _check_objective(case, rng, X, Y, jmodel, cfg, steps):
    """ELBO value and gradients at fixed draws, and a ``steps``-step Adam
    trajectory against optax, of the port model built with ``cfg`` from
    ``jmodel``."""
    model = _port_model(X, Y, jmodel, cfg)
    params = dict(model.named_parameters())
    trainable = {k for k, v in _flat(trainable_mask(jmodel)).items() if v}

    def jax_at(m, idx, zs):
        return _jax_loss_and_grads(m, jnp.asarray(X[idx]),
                                   jnp.asarray(Y[idx]),
                                   [jnp.asarray(z) for z in zs])

    idx, zs = _draws(rng, X.shape[0])
    jloss, jgrads = jax_at(jmodel, idx, zs)
    loss = model.loss(X[idx], Y[idx], zs=zs) - port.log_prior(model)
    loss.backward()
    _close(f"{case}ELBO at fixed draws", loss, jloss)
    jgrads = _flat(jgrads)
    for name in sorted(trainable):
        _close(f"{case}ELBO gradient {name}", params[name].grad,
               jgrads[name])

    # Adam steps with the same minibatches and draws
    model = _port_model(X, Y, jmodel, cfg)
    step = make_sgd_train_step(port_masked_optimizer(model, LR), BATCH)
    tx = masked_optimizer(optax.adam(LR), jmodel)
    opt_state = tx.init(jmodel)
    jm = jmodel
    for t in range(steps):
        idx, zs = _draws(rng, X.shape[0])
        jl, grads = jax_at(jm, idx, zs)
        updates, opt_state = tx.update(grads, opt_state, jm)
        jm = optax.apply_updates(jm, updates)
        tl = step(model, idx=torch.as_tensor(idx), zs=zs)
        assert_allclose(tl.numpy(), np.asarray(jl), rtol=TRAJ_RTOL,
                        atol=TRAJ_ATOL, err_msg=f"{case}Adam trajectory "
                                                f"loss, step {t}")
    want = _flat(jm)
    for name, p in model.named_parameters():
        assert_allclose(p.detach().numpy(), want[name], rtol=TRAJ_RTOL,
                        atol=TRAJ_ATOL, err_msg=f"{case}Adam trajectory "
                                                f"{name} after {steps} steps")


def _check_training(rng, X, Y, jmodel):
    """ELBO value and gradients at fixed draws, a 20-step Adam trajectory
    against optax, a CPU fit, and fit's unported options."""
    model = _port_model(X, Y, jmodel)
    params = dict(model.named_parameters())
    assert len({p.data_ptr() for p in params.values()}) == len(params), (
        "parameters share storage")
    trainable = {k for k, v in _flat(trainable_mask(jmodel)).items() if v}
    assert trainable == {k for k, p in params.items() if p.requires_grad}, (
        "trainable parameters differ from the JAX trainable_mask")
    _check_objective("", rng, X, Y, jmodel, port.Config(**FUSED), STEPS)

    # fit on the CPU: whole chunks, a history entry per log_every
    model, hist = port.fit(_port_model(X, Y, jmodel), iterations=20,
                           batch_size=BATCH, seed=3, log_every=10)
    assert [h["iter"] for h in hist] == [10, 20], f"fit history {hist}"
    assert all(np.isfinite(h["loss"]) for h in hist), f"fit loss {hist}"
    # its own stream, so that the cases after it keep their draws
    _check_natgrad(np.random.RandomState(44), X, Y, jmodel)
    _check_resume("DGP", lambda: _port_model(X, Y, jmodel), k=10,
                  batch_size=BATCH, seed=3, log_every=10, scan_steps=5)
    # the guard works for the DGP too, and is off for it by default
    assert "rejected" not in hist[0], "fit(DGP): the guard is on by default"
    model, hist = port.fit(model, iterations=10, batch_size=BATCH, seed=3,
                           log_every=10, reject_nonfinite=True)
    assert [h["iter"] for h in hist] == [10] and hist[0]["rejected"] == 0 \
        and np.isfinite(hist[0]["loss"]), f"fit(DGP, guard on) {hist}"


def _check_default_config(rng, X, Y, Xt, Yt):
    """The DGP under the default numerics of both packages (the port's
    ``Config()``: float64, jitter 1e-6, solve_mode='solve', use_pallas
    False): ELBO and gradient at fixed draws and 5 Adam steps against JAX;
    predict_all_layers (diagonal and full covariance) and
    predict_f_full_cov at fixed draws against the JAX propagate;
    ``remat=True`` bit for bit the values and gradients of ``remat=False``
    with one seeded generator; and the cached model's ELBO refused with
    the reference's message."""
    jmodel = _jax_model(rng, X, Y, numerics={})
    _check_objective("default Config(): ", rng, X, Y, jmodel, port.Config(),
                     5)
    model = _port_model(X, Y, jmodel, port.Config())
    zs = [rng.randn(S, N, d) for d in (H, H, 1)]
    jax_side = jax.jit(lambda m, x, z: (m.propagate(x, S=S, zs=z),
                                        m.propagate(x, S=S, zs=z,
                                                    full_cov=True)))
    wants = jax_side(jmodel, jnp.asarray(Xt), [jnp.asarray(z) for z in zs])
    for full_cov, want in zip((False, True), wants):
        got = (model.predict_all_layers_full_cov(Xt, S=S, zs=zs) if full_cov
               else model.predict_all_layers(Xt, S=S, zs=zs))
        for l in range(3):
            for what, g, w in zip(("F", "mean", "var"), got, want):
                _close(f"default Config(): predict_all_layers"
                       f"{'_full_cov' if full_cov else ''} layer {l} {what}",
                       g[l], w[l])
    for what, g, w in zip(("mean", "var"),
                          model.predict_f_full_cov(Xt, S=S, zs=zs),
                          (want[1][-1], want[2][-1])):
        assert g.shape == w.shape, f"predict_f_full_cov {what} {g.shape}"
        _close(f"default Config(): predict_f_full_cov {what}", g, w)

    runs = []
    for remat in (False, True):
        m = _port_model(X, Y, jmodel, port.Config(remat=remat))
        assert m.remat is remat, f"remat={remat}: not snapshotted"
        gen = torch.Generator()
        gen.manual_seed(7)
        loss = m.loss(generator=gen)
        loss.backward()
        runs.append((loss, [p.grad for p in m.parameters()]))
    (l0, g0), (l1, g1) = runs
    assert torch.equal(l0, l1), "remat=True: the loss differs in its bits"
    assert all(a is None and b is None or torch.equal(a, b)
               for a, b in zip(g0, g1)), (
        "remat=True: a gradient differs in its bits")

    try:
        dsd.precompute(jmodel).layers[0].KL()
    except NotImplementedError as e:
        want_msg = str(e)
    try:
        port.precompute(model).elbo(X, Y, zs=[rng.randn(S, 60, d)
                                              for d in (H, H, 1)])
    except NotImplementedError as e:
        assert str(e) == want_msg, f"precompute(model).elbo(): {e}"
    else:
        raise AssertionError("precompute(model).elbo() did not raise")


def _check_evaluate_regression(rng, X, Y, Xt, Yt):
    """A 1-layer DGP, whose predictions do not depend on the draws: the
    port's evaluate_regression equals the JAX one."""
    with temp_config(use_pallas=True, solve_mode="inverse", jitter=1e-6):
        jm = dsd.DGP.build(X, Y, X[:M], [dsd.RBF.make(D, lengthscales=1.3)],
                           dsd.Gaussian.make(0.1))
    layer = jm.layers[0]
    jm = jm.replace(layers=[layer.replace(
        q_mu=layer.q_mu.with_value(rng.randn(M, 1)),
        q_sqrt=layer.q_sqrt.with_value(
            np.tril(rng.randn(1, M, M) * 0.2) + 0.3 * np.eye(M)))])
    cfg = port.Config(use_pallas=True, solve_mode="inverse", jitter=1e-6)
    tm = port.DGP.build(X, Y, X[:M], [port.RBF(D)], port.Gaussian(1.0),
                        config=cfg, device="cpu")
    port.load_reference_state(tm, _flat(jm))
    kw = dict(S=5, batch_size=16, seed=2)
    want = jax_evaluate_regression(jm, Xt, Yt, 1.7, **kw)
    got = port.evaluate_regression(tm, Xt, Yt, 1.7, **kw)
    for key in ("rmse", "nll", "loglik"):
        assert_allclose(got[key], want[key], rtol=RTOL, atol=ATOL,
                        err_msg=f"evaluate_regression {key}")


def _collapsed_models(rng):
    """The two collapsed DGPs at L=2, built in JAX with a posterior moved
    off its initialization, with their port builders and draws for 9 test
    rows: hidden
    width 2 for DGPDamianou, the inner SVGP layer on the fused branch for
    DGPCollapsed.  DGPCollapsed hands one ``zs`` to the training-data and
    to the test propagation, so its draws broadcast over both row
    counts."""
    Nc, Dc, Mc, Hc = 40, 3, 12, 2
    X = rng.randn(Nc, Dc)
    Y = np.sin(X[:, :1]) + 0.1 * rng.randn(Nc, 1)
    with temp_config(jitter=1e-6, solve_mode="inverse", use_pallas=True):
        jd = dsd.DGPDamianou.build(
            X, Y, X[:Mc], [dsd.RBF.make(Dc), dsd.RBF.make(Hc, lengthscales=1.3)],
            dsd.Gaussian.make(0.05))
        jd = jd.replace(
            h_var=[p.with_value(np.exp(rng.randn(Nc, Hc)) * 0.05)
                   for p in jd.h_var],
            h_mean=[p.with_value(p.value + 0.3 * rng.randn(Nc, Hc))
                    for p in jd.h_mean])
        layers = dsd.init_layers_linear(
            X, Y, X[:Mc], [dsd.RBF.make(Dc),
                           dsd.RBF.make(Dc, lengthscales=1.2)], num_outputs=1)
        top = layers[-1]
        inner = layers[0].replace(q_mu=layers[0].q_mu.with_value(
            rng.randn(Mc, Dc) * 0.3))
        jc = dsd.DGPCollapsed.make(X, Y, dsd.Gaussian.make(0.05), [
            inner, JSGPRLayer.make(top.kern, np.asarray(top.Z.value), 1,
                                   top.mean_function)])

    def build_damianou(cfg):
        return port.DGPDamianou.build(X, Y, X[:Mc], [port.RBF(Dc),
                                                     port.RBF(Hc)],
                                      port.Gaussian(1.0), config=cfg,
                                      device="cpu")

    def build_collapsed(cfg):
        return port.DGPCollapsed.build(X, Y, X[:Mc], [port.RBF(Dc),
                                                      port.RBF(Dc)],
                                       port.Gaussian(1.0), config=cfg,
                                       device="cpu")

    return [("DGPDamianou", jd, build_damianou,
             [rng.randn(S, 9, d) for d in (Hc, 1)]),
            ("DGPCollapsed", jc, build_collapsed,
             [rng.randn(1, 1, d) for d in (Dc, 1)])]


def _check_collapsed(rng, Xt, Yt):
    """The collapsed bound, predict_y and predict_density at fixed draws
    on both psi2 routes ('xla': the plain path; 'auto': the kernel route,
    whose psi2 on the CPU is the kernel's plain version), the
    bound's gradient on the plain path against jax.grad, and the
    trainer's refusal of a minibatch for full-batch bounds."""
    Xt, Yt = Xt[:9, :3], Yt[:9]
    for name, jm, build, zs in _collapsed_models(rng):
        @jax.jit
        def jax_side(m):
            _, means, vars_ = m.propagate(jnp.asarray(Xt), S=S,
                                          zs=[jnp.asarray(z) for z in zs])
            y = m.likelihood.predict_mean_and_var(means[-1], vars_[-1])
            dens = logsumexp(m.likelihood.predict_density(
                means[-1], vars_[-1], jnp.asarray(Yt)) - jnp.log(S), axis=0)
            return m.elbo(), jax.grad(lambda mm: mm.elbo())(m), y, dens

        jbound, jgrads, jy, jdens = jax_side(jm)
        jfull = jax.jit(lambda m: m.propagate(
            jnp.asarray(Xt), S=S, full_cov=True,
            zs=[jnp.asarray(z) for z in zs]))(jm)
        jgrads = _flat(jgrads)
        jcached = jax.jit(lambda m: dsd.precompute(m).propagate(
            jnp.asarray(Xt), S=S, zs=[jnp.asarray(z) for z in zs]))(jm)
        for impl in ("xla", "auto"):
            case = f"{name} psi2_impl={impl}"
            cfg = port.Config(jitter=1e-6, solve_mode="inverse",
                              use_pallas=True, psi2_impl=impl)
            model = port.load_reference_state(build(cfg), _flat(jm))
            bound = model.elbo()
            _close(f"{case} bound", bound, jbound)
            for what, got, want in zip(("mean", "var"),
                                       model.predict_y(Xt, S=S, zs=zs), jy):
                _close(f"{case} predict_y {what}", got, want)
            _close(f"{case} predict_density",
                   model.predict_density(Xt, Yt, S=S, zs=zs), jdens)
            if impl == "xla":
                got = model.propagate(Xt, S=S, zs=zs, full_cov=True)
                for l in range(2):
                    for what, g, w in zip(("F", "mean", "var"), got, jfull):
                        _close(f"{case} propagate full_cov layer {l} {what}",
                               g[l], w[l])
                bound.backward()
                for pname, p in model.named_parameters():
                    g = torch.zeros_like(p) if p.grad is None else p.grad
                    _close(f"{case} bound gradient {pname}", g,
                           jgrads[pname])
        # precompute's collapsed branch against JAX's and the live model
        cached = port.precompute(model)
        assert type(cached) is port.DGPBase and not any(
            p.requires_grad for p in cached.parameters()), (
            f"{name}: precompute's model")
        # the diagonal against JAX's precompute; both against the live
        # model, whose full covariances the case above holds against JAX
        for full_cov in (False, True):
            what = "propagate full_cov" if full_cov else "propagate"
            got = cached.propagate(Xt, S=S, zs=zs, full_cov=full_cov)
            live = model.propagate(Xt, S=S, zs=zs, full_cov=full_cov)
            for l in range(2):
                for k, part in enumerate(("F", "mean", "var")):
                    case = f"{name} precompute {what} layer {l} {part}"
                    if not full_cov:
                        _close(case, got[k][l], jcached[k][l])
                    assert_allclose(got[k][l].numpy(),
                                    live[k][l].detach().numpy(), rtol=1e-7,
                                    atol=1e-9, err_msg=f"{case} vs live")
        with no_host_reads():
            request = port.make_server(model, S=S)(Xt, seed=2)
        assert all(torch.isfinite(t).all() and t.shape == (S, 9, 1)
                   for t in request), f"{name}: cached request"
        try:
            port.fit(model, iterations=1, batch_size=10)
        except ValueError:
            pass
        else:
            raise AssertionError(f"{name}: fit(batch_size=10) did not raise")
        step = make_sgd_train_step(port_masked_optimizer(model, LR), 10)
        try:
            step(model)
        except ValueError:
            pass
        else:
            raise AssertionError(f"{name}: a minibatch step did not raise")
        _check_collapsed_fit(name, jm, build)


GUARD_STEPS = 40
# scripted objectives for the guard: (name, steps whose loss is NaN, steps
# whose gradient of "a" is NaN, overflow).  Step GUARD_STEPS is the chunk's
# verification forward.  "overflow": one parameter at 1.7e308 pushed up by
# updates of 1e307, so candidates overflow although loss and gradients are
# finite.
GUARD_SCRIPTS = [
    ("no rejection", (), (), False),
    ("one rejection mid-chunk", (17,), (), False),
    ("two in a row, then 35 accepted (scale back to 1.0)", (), (3, 4), False),
    ("rejection at the first step", (0,), (), False),
    ("a non-finite gradient after a non-finite loss", (9,), (10, 20), False),
    ("non-finite verification forward", (GUARD_STEPS,), (), False),
    ("every step rejected", tuple(range(GUARD_STEPS + 1)), (), False),
    ("overflowing candidates", (), (), True),
]


@jax.jit
def _jax_guard_chunk(params, opt_state, lr, lin, quad, bad_loss, bad_grad):
    """One chunk of the JAX guarded_scan on the scripted objective
    sum(lin p) + 0.5 sum(quad (p - 1)^2)."""
    def base(p):
        return sum(jnp.sum(lin[k] * p[k])
                   + 0.5 * jnp.sum(quad[k] * (p[k] - 1.0) ** 2) for k in p)

    def loss_only(p, k):
        return jnp.where(bad_loss[k], jnp.nan, base(p))

    def loss_and_grads(p, k):
        grads = jax.grad(base)(p)
        grads = {**grads, "a": jnp.where(bad_grad[k], jnp.nan, grads["a"])}
        return loss_only(p, k), grads

    return jax_guarded_scan(loss_and_grads, loss_only, optax.adam(lr), params,
                            opt_state, jnp.arange(GUARD_STEPS + 1))


def _check_guard(rng):
    """The port's guarded_scan against the JAX guarded_scan on the scripted
    objectives, two chunks in a row (the second starts from the first's
    parameters and Adam state): parameters, Adam moments and count, and
    the reported nanmean."""
    names = ("a", "b")
    for script, nan_loss, nan_grad, overflow in GUARD_SCRIPTS:
        p0 = {"a": rng.randn(3), "b": rng.randn(2, 2)}
        lin = {k: np.zeros_like(v) for k, v in p0.items()}
        quad = {"a": np.array([1.0, 4.0, 0.3]), "b": np.full((2, 2), 2.0)}
        lr = 0.1
        if overflow:
            p0["a"] = np.array([1.7e308, 1.0, -1.0])
            lin["a"] = np.array([-1.0, 0.0, 0.0])
            quad = {k: np.zeros_like(v) for k, v in p0.items()}
            lr = 1e307
        bad_loss = np.zeros(GUARD_STEPS + 1, bool)
        bad_grad = np.zeros(GUARD_STEPS + 1, bool)
        bad_loss[list(nan_loss)] = True
        bad_grad[list(nan_grad)] = True

        def base(params):
            return sum(torch.sum(torch.from_numpy(lin[k]) * p)
                       + 0.5 * torch.sum(torch.from_numpy(quad[k])
                                         * (p - 1.0) ** 2)
                       for k, p in zip(names, params))

        def loss_only(params, k):
            return (torch.tensor(np.nan, dtype=torch.float64) if bad_loss[k]
                    else base(params))

        def loss_and_grads(params, k):
            leaves = [p.detach().requires_grad_() for p in params]
            grads = list(torch.autograd.grad(base(leaves), leaves))
            if bad_grad[k]:
                grads[0] = torch.full_like(grads[0], np.nan)
            return loss_only(params, k), grads

        jp = {k: jnp.asarray(v) for k, v in p0.items()}
        jstate = optax.adam(lr).init(jp)
        tp = [torch.from_numpy(p0[k].copy()) for k in names]
        tx = Adam(tp, lr=lr)
        tstate = tx.init()
        rejected = 0
        for chunk in range(2):
            case = f"guard [{script}] chunk {chunk}"
            jp, jstate, jloss = _jax_guard_chunk(
                jp, jstate, lr, lin, quad, bad_loss, bad_grad)
            tstate, tloss, r = guarded_scan(
                loss_and_grads, loss_only, tx, tp, tstate,
                range(GUARD_STEPS + 1))
            rejected += r
            assert_allclose(tloss, float(jloss), rtol=1e-9, equal_nan=True,
                            err_msg=f"{case}: reported loss")
            assert tstate.count == int(jstate[0].count), f"{case}: Adam count"
            for k, p, mu, nu in zip(names, tp, tstate.mu, tstate.nu):
                for what, got, want in (("parameter", p, jp[k]),
                                        ("Adam mu", mu, jstate[0].mu[k]),
                                        ("Adam nu", nu, jstate[0].nu[k])):
                    assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                                    atol=0, err_msg=f"{case}: {what} {k}")
        assert all(torch.isfinite(p).all() for p in tp), (
            f"guard [{script}]: non-finite parameters")
        clean = script == "no rejection"
        assert (rejected == 0) == clean, (
            f"guard [{script}]: {rejected} rejected steps")
        if script == "every step rejected":
            assert rejected == 2 * (GUARD_STEPS + 1) and torch.isnan(tloss) and all(
                np.array_equal(p.numpy(), p0[k]) for k, p in zip(names, tp)
            ), f"guard [{script}]: the state moved"


def _check_resume(case, fresh, k, **kw):
    """fit with checkpoints: k steps, a checkpoint, and a fit of a fresh
    model resumed to 2k, against 2k straight steps, bit for bit (the
    parameters and the last logged loss); latest_step on an empty and on
    a filled directory."""
    with tempfile.TemporaryDirectory() as d:
        assert latest_step(d) is None and latest_step(
            os.path.join(d, "absent")) is None, f"{case}: latest_step empty"
        straight, want = port.fit(fresh(), iterations=2 * k, **kw)
        port.fit(fresh(), iterations=k, ckpt_dir=d, **kw)
        assert latest_step(d) == k, f"{case}: latest_step {latest_step(d)}"
        resumed, hist = port.fit(fresh(), iterations=2 * k, ckpt_dir=d, **kw)
        assert latest_step(d) == 2 * k, f"{case}: no checkpoint at {2 * k}"
        assert hist[0]["iter"] > k and hist[-1]["loss"] == want[-1]["loss"], (
            f"{case}: resumed history {hist} against {want}")
        for (name, p), q in zip(resumed.named_parameters(),
                                straight.parameters()):
            assert torch.equal(p, q), (
                f"{case}: the resumed fit differs from the straight one in "
                f"{name}")


def _check_no_host_reads(X, Y, jmodel, Xt):
    """A plain training chunk and a live and a cached request with no
    host read and no value-shaped op: the code a CUDA graph captures on
    the card."""
    model = _port_model(X, Y, jmodel)
    chunk = make_scan_train_step(port_masked_optimizer(model, LR), BATCH,
                                 inner_steps=2)
    live = port.make_server(model, S=S, precompute=False)
    cached = port.make_server(model, S=S, precompute=True)
    Xq = torch.as_tensor(Xt)
    with no_host_reads():
        loss = chunk(model, generator=torch.Generator().manual_seed(0))
        requests = [serve(Xq, seed=4) for serve in (live, cached)]
    assert torch.isfinite(loss) and all(
        torch.isfinite(t).all() for r in requests for t in r), (
        "no host read: non-finite chunk loss or request")


def _check_collapsed_fit(name, jm, build):
    """fit on a collapsed model: the guard on by fit's own rule.  A chunk
    that is never rejected takes bit for bit the unguarded steps;
    DGPDamianou (whose bound draws nothing) tracks the JAX fit;
    DGPCollapsed trains to a finite, lower loss."""
    cfg = port.Config(jitter=1e-6, solve_mode="inverse", use_pallas=True)

    def fresh():
        return port.load_reference_state(build(cfg), _flat(jm))

    kw = dict(iterations=16, learning_rate=LR, scan_steps=8, log_every=8)
    model, hist = port.fit(fresh(), **kw)
    assert [h["iter"] for h in hist] == [8, 16] and all(
        h["rejected"] == 0 for h in hist), f"{name}: fit history {hist}"
    losses = [h["loss"] for h in hist]
    assert np.isfinite(losses).all() and losses[1] < losses[0], (
        f"{name}: fit loss {losses}")
    if name != "DGPDamianou":
        model = fresh()
        guarded = make_scan_train_step(port_masked_optimizer(model, LR),
                                       inner_steps=8, reject_nonfinite=True)
        with no_host_reads():
            loss = guarded(model, generator=torch.Generator().manual_seed(0))
        assert torch.isfinite(loss) and guarded.rejected == 0 and all(
            torch.isfinite(p).all() for p in model.parameters()), (
            f"{name}: guarded chunk with no host read")
        _check_resume(name, fresh, k=8, learning_rate=LR, scan_steps=8,
                      log_every=8)
        return
    # two guarded chunks of 8 against 16 unguarded steps, bit for bit
    plain = fresh()
    step = make_sgd_train_step(port_masked_optimizer(plain, LR))
    for _ in range(16):
        step(plain)
    for (pname, p), q in zip(model.named_parameters(), plain.parameters()):
        assert torch.equal(p, q), (
            f"{name}: a never-rejected guarded fit differs from the "
            f"unguarded steps in {pname}")
    guarded = make_scan_train_step(port_masked_optimizer(fresh(), LR),
                                   inner_steps=8, reject_nonfinite=True)
    assert guarded.rejected == 0, f"{name}: rejection counter"
    _, off = port.fit(fresh(), reject_nonfinite=False, **kw)
    assert "rejected" not in off[0], f"{name}: reject_nonfinite=False"
    assert_allclose([h["loss"] for h in off], losses, rtol=1e-12,
                    err_msg=f"{name}: fit with reject_nonfinite=False")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, short = port.fit(fresh(), iterations=8, learning_rate=LR,
                            scan_steps=2)
    assert any("raising scan_steps" in str(w.message) for w in caught), (
        f"{name}: no 'raising scan_steps' warning at scan_steps=2")
    assert_allclose(short[0]["loss"], losses[0], rtol=1e-12,
                    err_msg=f"{name}: scan_steps=2 raised to 8")
    with temp_config(jitter=1e-6, solve_mode="inverse", use_pallas=True):
        _, jhist = jax_fit(jm, 16, learning_rate=LR, scan_steps=8,
                           log_every=8)
    assert_allclose(losses, [h["loss"] for h in jhist], rtol=1e-6,
                    err_msg=f"{name}: fit history against the JAX fit")


# ---------------------------------------------------------------------------
# the quadrature DGP, the heteroscedastic DGP and input propagation
# ---------------------------------------------------------------------------

def _randomised(layers, rng, scale=0.3):
    """JAX layers with a posterior moved off its initialization."""
    out = []
    for layer in layers:
        Mi, Do = layer.q_mu.value.shape
        q_sqrt = np.tril(rng.randn(Do, Mi, Mi) * 0.2) + 0.5 * np.eye(Mi)
        out.append(layer.replace(
            q_mu=layer.q_mu.with_value(rng.randn(Mi, Do) * scale),
            q_sqrt=layer.q_sqrt.with_value(q_sqrt)))
    return out


def _named_grads(model):
    return {n: (torch.zeros_like(p) if p.grad is None else p.grad)
            for n, p in model.named_parameters() if p.requires_grad}


def _check_grads(case, model, jgrads):
    jgrads = _flat(jgrads)
    for name, g in _named_grads(model).items():
        _close(f"{case} gradient {name}", g, jgrads[name])


def _close_value(case, got, want):
    assert_allclose(got.detach().numpy(), np.asarray(want),
                    rtol=VALUE_RTOL, atol=ATOL, err_msg=case)


def _check_quad(rng):
    """DGPQuad at the JAX TestQuad shape (N=2, two RBF(1) layers with
    lengthscale 0.1, Z = X) with H=20: the bound is the same bits twice,
    and its value and gradients equal the JAX bound's; a chunk with no
    host read; precompute keeps the class and the grids."""
    X = rng.uniform(size=(2, 1))
    Y = np.sin(20 * X) + rng.randn(2, 1) * 0.001
    jlayers = dsd.init_layers_linear(
        X, Y, X, [dsd.RBF.make(1, lengthscales=0.1),
                  dsd.RBF.make(1, lengthscales=0.1)])
    jm = dsd.DGPQuad.build(X, Y, dsd.Gaussian.make(0.01),
                           _randomised(jlayers, rng), H=20)
    layers = port.init_layers_linear(X, Y, X, [port.RBF(1), port.RBF(1)])
    tm = port.DGPQuad.build(X, Y, port.Gaussian(1.0), layers, H=20,
                            device="cpu")
    assert {"gh_x.0", "gh_x.1", "gh_w"} <= dict(tm.named_buffers()).keys(), (
        f"DGPQuad buffers {list(dict(tm.named_buffers()))}")
    port.load_reference_state(tm, _flat(jm))
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda m: m.loss()))(jm)
    loss = tm.loss()
    assert torch.equal(loss, tm.loss()), "DGPQuad: the bound is not the " \
                                         "same bits twice"
    loss.backward()
    _close_value("DGPQuad H=20 bound", loss, jloss)
    _check_grads("DGPQuad H=20 bound", tm, jgrads)
    cached = port.precompute(tm)
    assert type(cached) is port.DGPQuad and torch.equal(
        cached.gh_w, tm.gh_w), "precompute(DGPQuad) lost its class or grids"
    chunk = make_scan_train_step(port_masked_optimizer(tm, LR),
                                 inner_steps=2)
    with no_host_reads():
        first = chunk(tm, generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(first), "DGPQuad chunk with no host read"


def _jax_hetero_loss(model, X, Y, zs):
    """The JAX heteroscedastic ELBO (the package's own E_log_p_Y) at fixed
    draws: its _predict, which draws from a key, takes ``zs`` instead."""
    def fixed(self, X, key=None, full_cov=False, S=1):
        return dsd.DGPBase._predict(self, X, full_cov=full_cov, S=S, zs=zs)

    with mock.patch.object(dsd.DGPHeteroscedastic, "_predict", fixed):
        return model.loss(X, Y)


_jax_hetero_loss_and_grads = jax.jit(jax.value_and_grad(_jax_hetero_loss))


@jax.jit
def _jax_hetero_predictions(model, X, Y, zs):
    Fmean, Fvar = model._predict(X, S=S, zs=zs)
    dens = logsumexp(model.sample_log_densities(Fmean, Fvar, Y)
                     - jnp.log(S), axis=0)
    return model.sample_predict_y(Fmean, Fvar), dens


def _check_heteroscedastic(rng, Xt, Yt):
    """DGPHeteroscedastic, 2 layers with num_outputs=2 on the fused
    branch: the ELBO and its gradients at fixed draws, predict_y and
    predict_density against JAX, also with the noise head above 20 (a
    Constant mean of 25 on it, which pins softplus as logaddexp(g, 0)); the
    cached model keeps the class and its y-space hooks; a chunk and a live
    and a cached request with no host read."""
    X, Y = rng.randn(60, D), rng.randn(60, 1)
    for head in (0.0, 25.0):
        case = f"DGPHeteroscedastic noise head mean {head}: "
        with temp_config(**FUSED):
            jlayers = dsd.init_layers_linear(
                X, Y, X[:M], [dsd.RBF.make(D) + dsd.White.make(D, 2e-6),
                              dsd.RBF.make(H, lengthscales=1.3)],
                num_outputs=2, mean_function=dsd.ConstantMean.make(
                    [0.1, head]))
        jm = dsd.DGPHeteroscedastic.make(X, Y, dsd.Gaussian.make(0.05),
                                         _randomised(jlayers, rng),
                                         num_samples=S)
        tm = port.DGPHeteroscedastic.build(
            X, Y, X[:M], [port.RBF(D) + port.White(D), port.RBF(H)],
            port.Gaussian(1.0), mean_function=port.ConstantMean([0.0, 0.0]),
            num_samples=S, config=port.Config(**FUSED), device="cpu")
        port.load_reference_state(tm, _flat(jm))
        idx = rng.randint(0, 60, BATCH)
        zs = [rng.randn(S, BATCH, d) for d in (H, 2)]
        jloss, jgrads = _jax_hetero_loss_and_grads(
            jm, jnp.asarray(X[idx]), jnp.asarray(Y[idx]),
            [jnp.asarray(z) for z in zs])
        loss = tm.loss(X[idx], Y[idx], zs=zs)
        loss.backward()
        _close_value(f"{case}ELBO at fixed draws", loss, jloss)
        _check_grads(f"{case}ELBO", tm, jgrads)
        zt = [rng.randn(S, N, d) for d in (H, 2)]
        Fm = tm.predict_f(Xt, S=S, zs=zt)[0]
        if head:
            assert Fm[..., 1].min() > 20, (
                f"{case}the noise head's mean {Fm[..., 1].min()} is not "
                f"above 20")
        (jmean, jvar), jdens = _jax_hetero_predictions(
            jm, jnp.asarray(Xt), jnp.asarray(Yt), [jnp.asarray(z) for z in zt])
        for name, m in (("live", tm), ("cached", port.precompute(tm))):
            assert type(m) is port.DGPHeteroscedastic, (
                f"{case}precompute lost the class")
            mean, var = m.predict_y(Xt, S=S, zs=zt)
            dens = m.predict_density(Xt, Yt, S=S, zs=zt)
            assert dens.shape == (N, 1), f"{case}density {dens.shape}"
            for what, g, w in (("predict_y mean", mean, jmean),
                               ("predict_y var", var, jvar),
                               ("predict_density", dens, jdens)):
                _close_value(f"{case}{name} {what}", g, w)
    # the noise link across torch's softplus threshold of 20, above which
    # F.softplus returns G itself (6e-11 relative off at G = 20.5)
    G = np.linspace(15.0, 40.0, 101)
    assert_allclose(tm._noise(torch.as_tensor(G)).numpy(),
                    np.asarray(jax.nn.softplus(jnp.asarray(G)) + jm.min_noise),
                    rtol=1e-15, atol=0,
                    err_msg="DGPHeteroscedastic noise link above 20")
    chunk = make_scan_train_step(port_masked_optimizer(tm, LR), BATCH,
                                 inner_steps=2)
    live = port.make_server(tm, S=S, precompute=False,
                            method="predict_density")
    cached = port.make_server(tm, S=S, precompute=True,
                              method="predict_density")
    Xq, Yq = torch.as_tensor(Xt), torch.as_tensor(Yt)
    with no_host_reads():
        loss = chunk(tm, generator=torch.Generator().manual_seed(0))
        requests = [serve(Xq, Yq, seed=4) for serve in (live, cached)]
    assert torch.isfinite(loss) and all(
        torch.isfinite(r).all() and r.shape == (N, 1) for r in requests), (
        "DGPHeteroscedastic with no host read: non-finite or misshapen")


def _check_input_prop(rng, Xt):
    """The input-propagation stack RBF(5) -> RBF(7) -> RBF(7) (hidden width
    2) on the fused branch: Z bit for bit from the default RandomState(0),
    then the ELBO and its gradients at fixed draws, and
    predict_all_layers(_full_cov) against the JAX propagate (shapes: the 5
    input columns in front of each inner layer's outputs); the cached
    layers keep input_prop_dim and the cached model's predictions."""
    X, Y = rng.randn(60, D), rng.randn(60, 1)
    Hp = 2
    widths = (D, D + Hp, D + Hp)
    with temp_config(**FUSED):
        jlayers = dsd.init_layers_input_prop(
            X, Y, X[:M], [dsd.RBF.make(w, lengthscales=1.2) for w in widths])
    cfg = port.Config(**FUSED)
    layers = port.init_layers_input_prop(X, Y, X[:M],
                                         [port.RBF(w) for w in widths],
                                         config=cfg)
    for l, (jl, tl) in enumerate(zip(jlayers, layers)):
        assert np.array_equal(tl.Z.value.detach().numpy(),
                              np.asarray(jl.Z.value)), (
            f"input prop layer {l}: Z differs from the JAX Z in its bits")
        assert tl.input_prop_dim == jl.input_prop_dim, (
            f"input prop layer {l}: input_prop_dim {tl.input_prop_dim}")
    jm = dsd.DGPBase.make(X, Y, dsd.Gaussian.make(0.05),
                          _randomised(jlayers, rng), num_samples=S)
    tm = port.DGPBase.make(X, Y, port.Gaussian(1.0), layers, num_samples=S,
                           config=cfg, device="cpu")
    port.load_reference_state(tm, _flat(jm))
    idx = rng.randint(0, 60, BATCH)
    zs = [rng.randn(S, BATCH, d) for d in (Hp, Hp, 1)]
    jloss, jgrads = _jax_loss_and_grads(jm, jnp.asarray(X[idx]),
                                        jnp.asarray(Y[idx]),
                                        [jnp.asarray(z) for z in zs])
    loss = tm.loss(X[idx], Y[idx], zs=zs) - port.log_prior(tm)
    loss.backward()
    _close_value("input prop ELBO at fixed draws", loss, jloss)
    _check_grads("input prop ELBO", tm, jgrads)
    zt = [rng.randn(S, N, d) for d in (Hp, Hp, 1)]
    jax_side = jax.jit(lambda m, x, z: (m.propagate(x, S=S, zs=z),
                                        m.propagate(x, S=S, zs=z,
                                                    full_cov=True)))
    wants = jax_side(jm, jnp.asarray(Xt), [jnp.asarray(z) for z in zt])
    cached = port.precompute(tm)
    assert [l.input_prop_dim for l in cached.layers] == [D, D, None], (
        "precompute lost input_prop_dim")
    for full_cov, want in zip((False, True), wants):
        tag = "_full_cov" if full_cov else ""
        for name, m in (("live", tm), ("cached", cached)):
            got = getattr(m, f"predict_all_layers{tag}")(Xt, S=S, zs=zt)
            for l in range(3):
                for what, g, w in zip(("F", "mean", "var"), got, want):
                    assert g[l].shape == w[l].shape, (
                        f"input prop {name} predict_all_layers{tag} layer "
                        f"{l} {what} shape {tuple(g[l].shape)}")
                    _close_value(f"input prop {name} predict_all_layers"
                                 f"{tag} layer {l} {what}", g[l], w[l])
            assert torch.equal(got[0][0][..., :D],
                               torch.as_tensor(Xt).expand(S, N, D)), (
                f"input prop {name}: layer 0's first {D} columns are not "
                f"the input")


# ---------------------------------------------------------------------------
# classification: the paper's MNIST DGP, cut to the committed fixture
# ---------------------------------------------------------------------------

MNIST_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "fixtures", "mnist_tiny.npz")
# the MNIST demo's numerics (float64 here), on the card's route
MNIST_NUMERICS = dict(use_pallas=True, solve_mode="inverse", jitter=1e-5)
CLS_M, CLS_H, CLS_K = 16, 4, 10
# predict_y's class probabilities and variances, which lie in [0, 1]:
# absolute.  The same float64 arithmetic summed in other orders; the
# randomised posterior's layer 1 means (~1e2) already differ by ~1e-9
# (Kuu's conditioning at jitter 1e-5), about 1e-11 in the probabilities
PROBS_ATOL = 1e-10
EVAL_RTOL = 1e-10


@jax.jit
def _jax_predict_y(model, X, zs):
    """The JAX predict_y moments at fixed draws (one compile, not one a
    dispatched op)."""
    _, means, variances = model.propagate(X, S=S, zs=zs)
    return model.likelihood.predict_mean_and_var(means[-1], variances[-1])


def _classifiers(d, rng, hidden=(CLS_H,)):
    """A JAX and a port MultiClass DGP on the fixture (the MNIST demo's
    architecture at test_mnist_path.py's sizes: RBF(2.0, 2.0) layers, D ->
    hidden -> 10), checked equal as built (the PCA projection included),
    then carried over with a randomised posterior."""
    Z = d["X"][rng.permutation(d["X"].shape[0])[:CLS_M]].astype(np.float64)
    widths = (d["X"].shape[1],) + tuple(hidden)
    with temp_config(**MNIST_NUMERICS):
        jm = dsd.DGP.build(
            d["X"].astype(np.float64), d["Y"], Z,
            [dsd.RBF.make(w, lengthscales=2.0, variance=2.0) for w in widths],
            dsd.MultiClass.make(CLS_K), num_outputs=CLS_K, num_samples=S)
    tm = port.DGP.build(d["X"], d["Y"], Z,
                        [port.RBF(w, lengthscales=2.0, variance=2.0)
                         for w in widths], port.MultiClass(CLS_K),
                        num_outputs=CLS_K, num_samples=S,
                        config=port.Config(**MNIST_NUMERICS), device="cpu")
    built = dict(tm.named_parameters())
    built.update(tm.named_buffers())
    want = _flat(jm)
    assert set(built) == set(want), (
        f"classifier as built: names differ {set(built) ^ set(want)}")
    for name, t in built.items():
        _close(f"classifier as built {name}", t, want[name])
    layers = []
    for layer in jm.layers:
        Mi, Do = layer.q_mu.value.shape
        q_sqrt = np.tril(rng.randn(Do, Mi, Mi) * 0.2) + 0.3 * np.eye(Mi)
        layers.append(layer.replace(
            q_mu=layer.q_mu.with_value(rng.randn(Mi, Do)),
            q_sqrt=layer.q_sqrt.with_value(q_sqrt)))
    jm = jm.replace(layers=layers)
    return jm, port.load_reference_state(tm, _flat(jm))


def _check_classification(rng):
    """The MNIST path against the JAX package: the loader, the DGP built
    from the fixture, its ELBO and gradients at fixed draws, predict_y's
    class probabilities, evaluate_classification, a fit with the monitors,
    and a training chunk and live and cached requests with no host read."""
    d = port.load_mnist_npz(MNIST_FIXTURE)
    jd = jax_load_mnist_npz(MNIST_FIXTURE)
    for key in ("X", "Y", "Xs", "Ys"):
        assert d[key].dtype == jd[key].dtype and np.array_equal(
            d[key], jd[key]), f"load_mnist_npz {key}"
    # the 784 -> 30 PCA projection of layer 0, at the MNIST width
    Xw = rng.uniform(size=(200, 784))
    np.testing.assert_array_equal(
        tinit._linear_projection(784, 30, Xw),
        jinit._linear_projection(784, 30, Xw),
        err_msg="PCA projection 784 -> 30")

    jm, model = _classifiers(d, rng)
    assert isinstance(model.layers[0].mean_function, port.Linear), (
        "classifier: layer 0 has no PCA Linear mean function")
    X, Y = d["X"].astype(np.float64), d["Y"]
    idx = rng.randint(0, X.shape[0], BATCH)
    zs = [rng.randn(S, BATCH, w) for w in (CLS_H, CLS_K)]
    jloss, jgrads = _jax_loss_and_grads(
        jm, jnp.asarray(X[idx]), jnp.asarray(Y[idx]),
        [jnp.asarray(z) for z in zs])
    loss = model.loss(X[idx], Y[idx], zs=zs) - port.log_prior(model)
    loss.backward()
    _close("classifier ELBO at fixed draws", loss, jloss)
    jgrads = _flat(jgrads)
    trainable = [k for k, p in model.named_parameters() if p.requires_grad]
    assert trainable, "classifier: no trainable parameter"
    for name, p in model.named_parameters():
        if p.requires_grad:
            _close(f"classifier ELBO gradient {name}", p.grad, jgrads[name])

    Xs = d["Xs"].astype(np.float64)
    zt = [rng.randn(S, len(Xs), w) for w in (CLS_H, CLS_K)]
    want = _jax_predict_y(jm, jnp.asarray(Xs), [jnp.asarray(z) for z in zt])
    got = model.predict_y(Xs, S=S, zs=zt)
    for what, a, b in zip(("probabilities", "variances"), got, want):
        assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=PROBS_ATOL,
                        err_msg=f"classifier predict_y {what}")
    assert bool(((got[0] > 0) & (got[0] < 1)).all()), (
        "classifier predict_y: a probability outside (0, 1)")

    # a 1-layer classifier predicts without inner draws: the port's
    # evaluate_classification equals the JAX one (ragged last batch)
    jm1, tm1 = _classifiers(d, rng, hidden=())
    kw = dict(S=3, batch_size=16, seed=2)
    want = jax_evaluate_classification(jm1, d["Xs"], d["Ys"], **kw)
    got = port.evaluate_classification(tm1, d["Xs"], d["Ys"], **kw)
    assert got["accuracy"] == want["accuracy"], (
        f"evaluate_classification accuracy {got} vs {want}")
    for key in ("loglik", "nll"):
        assert_allclose(got[key], want[key], rtol=EVAL_RTOL,
                        err_msg=f"evaluate_classification {key}")

    # fit with the monitors, on the CPU
    with tempfile.TemporaryDirectory() as tmp:
        log = JsonlLogger(os.path.join(tmp, "log", "train.jsonl"))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            model, hist = port.fit(
                model, iterations=4, batch_size=32, seed=1, log_every=2,
                scan_steps=2, callbacks=[FullElboCallback(),
                                         PrintTimings("mnist "), log])
        log.close()
        with open(log.path) as f:
            records = [json.loads(line) for line in f]
    assert [r["step"] for r in records] == [2, 4] and all(
        np.isfinite(r["loss"]) and np.isfinite(r["full_elbo"])
        for r in records), f"JsonlLogger records {records}"
    assert out.getvalue().startswith("mnist iter 2: loss "), (
        f"PrintTimings printed {out.getvalue()!r}")
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        assert hist[-1]["full_elbo"] == float(model.elbo(generator=g)), (
            "FullElboCallback: not the ELBO on the whole training set")
    # the same lines and records as the JAX monitors for the same event
    with tempfile.TemporaryDirectory() as tmp:
        outs = []
        for mod in (jmonitor, port.training.monitor):
            buf, log = io.StringIO(), mod.JsonlLogger(
                os.path.join(tmp, f"{mod.__name__}.jsonl"))
            with contextlib.redirect_stdout(buf):
                for step, stats in ((2, records[0]), (4, records[1])):
                    mod.PrintTimings("mnist ")(step, None, stats["loss"],
                                               dict(stats))
                    log(step, None, stats["loss"], dict(stats))
            log.close()
            with open(log.path) as f:
                outs.append((buf.getvalue(), f.read()))
    assert outs[0] == outs[1], f"monitors differ from the JAX ones: {outs}"

    chunk = make_scan_train_step(port_masked_optimizer(model, LR), 32,
                                 inner_steps=2)
    with no_host_reads():
        loss = chunk(model, generator=torch.Generator().manual_seed(0))
    # the cached server snapshots the parameters: made after the chunk
    live = port.make_server(model, S=S, precompute=False)
    cached = port.make_server(model, S=S, precompute=True)
    Xq = torch.as_tensor(Xs[:10])
    with no_host_reads():
        requests = [serve(Xq, seed=4) for serve in (live, cached)]
    assert torch.isfinite(loss) and all(
        torch.isfinite(t).all() and t.shape == (S, 10, CLS_K)
        for r in requests for t in r), (
        "classification with no host read: non-finite or misshapen")
    for what, a, b in zip(("probabilities", "variances"), *requests):
        assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL,
                        err_msg=f"classification live vs cached {what}")


# ---------------------------------------------------------------------------
# natural gradients, the gamma = 1 identities and L-BFGS
# ---------------------------------------------------------------------------

NG_GAMMA = 0.1


def _check_natgrad(rng, X, Y, jmodel):
    """The alternating NatGrad(gamma 0.1, last layer) + Adam step: 3
    iterations at fixed indices and two fixed sets of draws an iteration
    against the JAX oracle (TRAJ_RTOL); a CPU fit(natgrad_gamma=0.1) (its
    history, the last layer's q moved by the natural steps, the inner
    layers' by Adam, and a checkpoint whose Adam state holds every
    trainable parameter but the last layer's q); its resume bit for bit;
    and a chunk with no host read."""
    # the last layer at its prior, where the natural steps start in
    # practice (at the randomised posterior every gamma = 0.1 step goes
    # indefinite in both packages and the reject net keeps the old q)
    jmodel = _jax_model(rng, X, Y, randomise=(0, 1))
    tx = masked_optimizer(optax.adam(LR), jmodel,
                          freeze=jax_freeze_q_params((-1,), 3))
    opt_state = tx.init(jmodel)
    jitter = jmodel.layers[-1].jitter
    natural = jax.jit(lambda *a: jax_natgrad_update(*a, NG_GAMMA,
                                                    jitter=jitter))
    adam = jax.jit(tx.update)

    def jax_iter(model, opt_state, X, Y, z_nat, z_adam):
        """One iteration of the JAX alternating loop at fixed draws, from
        the package's natgrad_update and masked_optimizer(optax.adam,
        freeze=freeze_q_params((-1,), 3)); the gradients by the jitted
        objective the Adam cases compiled."""
        _, grads = _jax_loss_and_grads(model, X, Y, z_nat)
        layers = list(model.layers)
        layer, glayer = layers[-1], grads.layers[-1]
        m, L = natural(layer.q_mu.value, layer.q_sqrt.value,
                       glayer.q_mu.unconstrained,
                       jnp.tril(glayer.q_sqrt.unconstrained))
        layers[-1] = layer.replace(q_mu=layer.q_mu.with_value(m),
                                   q_sqrt=layer.q_sqrt.with_value(L))
        model = model.replace(layers=layers)
        loss, grads = _jax_loss_and_grads(model, X, Y, z_adam)
        updates, opt_state = adam(grads, opt_state, model)
        return optax.apply_updates(model, updates), opt_state, loss

    model = _port_model(X, Y, jmodel)
    optimizer = port_masked_optimizer(
        model, LR, freeze=port_freeze_q_params((-1,), 3))
    step = port.make_natgrad_adam_step(optimizer, NG_GAMMA, (-1,), BATCH)
    jm = jmodel
    for t in range(3):
        idx, z_nat = _draws(rng, X.shape[0])
        z_adam = _draws(rng, X.shape[0])[1]
        jm, opt_state, jl = jax_iter(
            jm, opt_state, jnp.asarray(X[idx]), jnp.asarray(Y[idx]),
            [jnp.asarray(z) for z in z_nat], [jnp.asarray(z) for z in z_adam])
        tl = step(model, idx=torch.as_tensor(idx), zs=(z_nat, z_adam))
        assert_allclose(tl.numpy(), np.asarray(jl), rtol=TRAJ_RTOL,
                        atol=TRAJ_ATOL,
                        err_msg=f"NatGrad+Adam trajectory loss, step {t}")
    want = _flat(jm)
    for name, p in model.named_parameters():
        assert_allclose(p.detach().numpy(), want[name], rtol=TRAJ_RTOL,
                        atol=TRAJ_ATOL, err_msg=f"NatGrad+Adam trajectory "
                                                f"{name} after 3 steps")
    assert int(step.rejected) == 0, "NatGrad+Adam: a natural step rejected"

    kw = dict(batch_size=BATCH, seed=3, log_every=10, scan_steps=5,
              natgrad_gamma=NG_GAMMA)
    before = _port_model(X, Y, jmodel)
    with tempfile.TemporaryDirectory() as d:
        fitted, hist = port.fit(_port_model(X, Y, jmodel), iterations=20,
                                ckpt_dir=d, **kw)
        with np.load(os.path.join(d, "ckpt_20.npz")) as ckpt:
            mu = [k for k in ckpt.files if k.startswith("1:mu:")]
    assert [h["iter"] for h in hist] == [10, 20] and all(
        np.isfinite(h["loss"]) and h["rejected"] == 0 for h in hist), (
        f"fit(natgrad_gamma) history {hist}")
    adam_names = [n for n, p in before.named_parameters() if p.requires_grad
                  and not n.startswith(("layers.2.q_mu", "layers.2.q_sqrt"))]
    assert len(mu) == len(adam_names), (
        f"fit(natgrad_gamma): the Adam state holds {len(mu)} tensors, not "
        f"the {len(adam_names)} unfrozen parameters")
    moved = dict(fitted.named_parameters())
    for name, p in before.named_parameters():
        if ".q_mu." in name or ".q_sqrt." in name:
            assert not torch.allclose(p, moved[name]), (
                f"fit(natgrad_gamma): {name} did not move")
    _check_resume("DGP natgrad", lambda: _port_model(X, Y, jmodel), k=10,
                  **kw)
    model = _port_model(X, Y, jmodel)
    optimizer = port_masked_optimizer(
        model, LR, freeze=port_freeze_q_params((-1,), 3))
    chunk = make_scan_train_step(
        optimizer, BATCH, inner_steps=2,
        step=port.make_natgrad_adam_step(optimizer, NG_GAMMA, (-1,), BATCH))
    with no_host_reads():
        loss = chunk(model, generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(loss) and chunk.rejected == 0, (
        "NatGrad+Adam chunk with no host read")


def _check_gamma1_identities():
    """One gamma = 1 natural step on a conjugate last layer lands on the
    collapsed bound: an SVGP's against SGPR's (rtol 1e-8), at
    tests/test_single_layer_models.py's shapes, and DGPQuad(H=200)'s last
    layer against DGPCollapsed's (rtol 1e-7), at tests/test_collapsed.py's
    (the same seeds and draws)."""
    cfg = port.Config(jitter=1e-12)
    rng = np.random.RandomState(0)
    X, Y, Z = rng.rand(12, 2), rng.randn(12, 2), rng.rand(5, 2)

    def kern():
        return port.RBF(2, variance=1.1, lengthscales=0.6)

    sgpr = port.SGPR.build(X, Y, kern(), Z, noise_variance=0.2, config=cfg,
                           device="cpu")
    svgp = port.SVGP.build(X, Y, kern(), port.Gaussian(0.2), Z, white=False,
                           config=cfg, device="cpu")
    with torch.no_grad():
        want, before = sgpr.log_likelihood(), svgp.log_likelihood()
    assert before < want, "SVGP's untrained bound is not below SGPR's"
    port.NaturalGradient(1.0, (0,)).step(svgp, lambda m: -m.log_likelihood())
    with torch.no_grad():
        got = svgp.log_likelihood()
    assert_allclose(got.item(), want.item(), rtol=1e-8,
                    err_msg="gamma=1 natural step: SVGP against SGPR")

    np.random.seed(100)
    N_, M_ = 1, 8
    X = np.random.uniform(size=(N_, 1))
    Y = np.random.uniform(size=(N_, 1))
    Z = np.random.uniform(size=(M_, 1))
    Z[:N_] = X[:M_]

    def kerns():
        return [port.RBF(1, lengthscales=0.1), port.RBF(1, lengthscales=0.5)]

    q_mu1 = np.random.randn(M_, 1)
    q_sqrt1 = np.tril(np.random.randn(M_, M_))[None]
    collapsed = port.DGPCollapsed.build(X, Y, Z, kerns(), port.Gaussian(0.1),
                                        config=cfg, device="cpu")
    layers = port.init_layers_linear(X, Y, Z, kerns(), config=cfg)
    quad = port.DGPQuad.build(X, Y, port.Gaussian(0.1), layers, H=200,
                              config=cfg, device="cpu")
    for m in (collapsed, quad):
        m.layers[0].q_mu.set_value(q_mu1)
        m.layers[0].q_sqrt.set_value(q_sqrt1)
    port.NaturalGradient(1.0, (-1,)).step(quad, lambda m: -m.elbo())
    with torch.no_grad():
        got, want = quad.elbo().item(), collapsed.elbo().item()
    assert_allclose(got, want, rtol=1e-7, atol=1e-7,
                    err_msg="gamma=1 natural step: DGPQuad against "
                            "DGPCollapsed")


# L-BFGS: the optimum's loss relative to JAX's, and each constrained
# parameter's value (flat directions, such as FITC's noise at its floor,
# leave the unconstrained values apart)
LBFGS_LOSS_RTOL, LBFGS_PARAM_TOL = 1e-7, 1e-5


def _check_lbfgs(rng):
    """lbfgs_minimize on small GPR, SGPR and GPRFITC problems (N=30, D=2,
    M=6, Z frozen in both packages) reaches the optimum of the JAX
    lbfgs_minimize, run once on the sum of the three objectives (they
    share no parameter, so its optimum is each one's; one compile of the
    JAX step instead of three); and on tests/test_training.py's 1-layer
    DGP at fixed zero draws it improves the loss by more than 1, as the
    JAX test asserts."""
    X = rng.rand(30, 2)
    Y = (np.sin(6 * X[:, :1]) * np.cos(4 * X[:, 1:])
         + 0.05 * rng.randn(30, 1))
    Z = X[::5].copy()
    cfg = port.Config(jitter=1e-8)
    with temp_config(jitter=1e-8):
        def jk():
            return dsd.RBF.make(2, lengthscales=0.5)

        cases = [("GPR", dsd.GPR.build(X, Y, jk(), noise_variance=0.1),
                  lambda: port.GPR.build(X, Y, port.RBF(2), config=cfg,
                                         device="cpu")),
                 ("SGPR", dsd.SGPR.build(X, Y, jk(), Z, noise_variance=0.1),
                  lambda: port.SGPR.build(X, Y, port.RBF(2), Z, config=cfg,
                                          device="cpu")),
                 ("GPRFITC", dsd.GPRFITC.build(X, Y, jk(), Z,
                                               noise_variance=0.1),
                  lambda: port.GPRFITC.build(X, Y, port.RBF(2), Z,
                                             config=cfg, device="cpu"))]
        jms, jl = jax_lbfgs_minimize(
            lambda ms: sum(-m.log_likelihood() for m in ms),
            tuple(jm for _, jm, _ in cases), max_iters=100, tol=1e-12,
            freeze=lambda path, p: "Z" in path)
    optimum = 0.0
    for (name, jm, build), jm2 in zip(cases, jms):
        tm, tl = port.lbfgs_minimize(
            lambda m: -m.log_likelihood(),
            port.load_reference_state(build(), _flat(jm)), max_iters=100,
            tol=1e-12, freeze=lambda n, p: n.endswith("Z.unconstrained"))
        ref = port.load_reference_state(build(), _flat(jm2))
        with torch.no_grad():
            ref_loss = -ref.log_likelihood().item()
        optimum += ref_loss
        assert_allclose(tl, ref_loss, rtol=LBFGS_LOSS_RTOL,
                        err_msg=f"lbfgs_minimize {name}: optimum loss")
        for (pname, p), q in zip(tm.named_modules(), ref.modules()):
            if isinstance(p, Param):
                assert_allclose(p.value.detach().numpy(),
                                q.value.detach().numpy(),
                                rtol=LBFGS_PARAM_TOL, atol=LBFGS_PARAM_TOL,
                                err_msg=f"lbfgs_minimize {name}: {pname}")
    # the JAX optimum's loss, as the port evaluates it
    assert_allclose(optimum, jl, rtol=LBFGS_LOSS_RTOL,
                    err_msg="lbfgs_minimize: the JAX optimum's loss")
    # tests/test_training.py's _step_data(20)
    step_rng = np.random.RandomState(0)
    Xs = step_rng.uniform(-1, 1, (20, 1))
    Ys = (Xs > 0).astype(float) + step_rng.randn(20, 1) * 0.02
    dgp = port.DGP.build(Xs, Ys, np.linspace(-1, 1, 6)[:, None],
                         [port.RBF(1, lengthscales=0.5)], port.Gaussian(0.05),
                         device="cpu")

    def loss(m):
        return -m.elbo(zs=[torch.zeros(1, 1, 1, dtype=torch.float64)])

    with torch.no_grad():
        l0 = loss(dgp).item()
    _, l1 = port.lbfgs_minimize(loss, dgp, max_iters=60)
    assert l1 < l0 - 1.0, f"lbfgs_minimize on the DGP: {l0} -> {l1}"


# ---------------------------------------------------------------------------
# the MCMC models, DynamicPredictor and export
# ---------------------------------------------------------------------------

MCMC_RTOL = 1e-9       # the MCMC models against JAX, float64
SGPMC_BRANCHES = {"solve": dict(solve_mode="solve", use_pallas=False),
                  "staged": dict(solve_mode="inverse", use_pallas=False),
                  "fused": dict(solve_mode="inverse", use_pallas=True)}


def _close9(case, got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert_allclose(got, np.asarray(want), rtol=MCMC_RTOL, atol=1e-12,
                    err_msg=case)


def _grads_close(case, tmod, jgrads, names):
    """Port gradients (already in .grad) against the JAX gradient pytree
    flattened to port names."""
    jg = _flat(jgrads)
    for name, p in tmod.named_parameters():
        if name in names:
            # a parameter the objective does not reach: JAX's zero
            g = torch.zeros_like(p) if p.grad is None else p.grad
            _close9(f"{case} d/d{name}", g, jg[name])


def _sgpmc_layer_case(rng, white, branch):
    """An SGPMCLayer (M=6, 3 -> 2) on one branch in both packages: the
    diagonal and (solve) full-covariance conditional, conditional_SND,
    the gradients of a weighted sum of them, KL and log_prior."""
    Mi, Dx, Do, B = 6, 3, 2, 9
    X, Z = rng.randn(B, Dx), rng.randn(Mi, Dx)
    q_mu = rng.randn(Mi, Do)
    wm, wv = rng.randn(B, Do), rng.randn(B, Do)
    Xs = rng.randn(2, 4, Dx)
    numerics = dict(jitter=1e-6, **SGPMC_BRANCHES[branch])
    with temp_config(**numerics):
        jl = dsd.SGPMCLayer.make(dsd.RBF.make(Dx, lengthscales=1.4)
                                 + dsd.White.make(Dx, variance=1e-5), Z, Do,
                                 white=white)
    jl = jl.replace(q_mu=jl.q_mu.with_value(q_mu))
    cfg = port.Config(dtype=torch.float64, **numerics)
    tl = port.SGPMCLayer(port.RBF(Dx) + port.White(Dx), Z, Do, white=white,
                         config=cfg)
    port.load_reference_state(tl, _flat(jl))
    assert tl.q_sqrt is None and "q_sqrt.unconstrained" not in dict(
        tl.named_parameters()), "SGPMCLayer carries a q_sqrt"

    def jf(layer):
        m, v = layer.conditional_ND(jnp.asarray(X))
        sm, sv = layer.conditional_SND(jnp.asarray(Xs))
        obj = jnp.sum(m * wm) + jnp.sum(v * wv) + jnp.sum(sm) + jnp.sum(sv)
        return obj, (m, v, sm, sv)

    (_, jout), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(jl)
    m, v = tl.conditional_ND(torch.as_tensor(X))
    sm, sv = tl.conditional_SND(torch.as_tensor(Xs))
    case = f"SGPMCLayer white={white} {branch}"
    want_cols = Do if branch == "fused" else 1
    assert v.shape == (B, want_cols), f"{case}: variance {tuple(v.shape)}"
    for what, g, w in zip(("mean", "var", "SND mean", "SND var"),
                          (m, v, sm, sv), jout):
        _close9(f"{case} {what}", g, w)
    obj = (torch.sum(m * torch.as_tensor(wm)) + torch.sum(
        v * torch.as_tensor(wv)) + sm.sum() + sv.sum())
    obj.backward()
    _grads_close(case, tl, jg, dict(tl.named_parameters()))
    assert float(tl.KL()) == 0.0 and float(jl.KL()) == 0.0, f"{case}: KL"
    _close9(f"{case} log_prior", port.log_prior(tl), log_prior(jl))
    if branch == "solve":
        jm_, jv_ = jl.conditional_ND(jnp.asarray(X), full_cov=True)
        tm_, tv_ = tl.conditional_ND(torch.as_tensor(X), full_cov=True)
        assert tv_.shape == (B, B, 1), f"{case}: full cov {tuple(tv_.shape)}"
        _close9(f"{case} full-cov mean", tm_, jm_)
        _close9(f"{case} full-cov var", tv_, jv_)
    return jl, tl


def _sgpmc_dgp(rng, X, Y, white):
    """A 2-layer SGPMC DGP (D -> 2 -> 1, M=6) in both packages on the
    fused branch, with a random posterior."""
    Z = X[:6]
    numerics = dict(jitter=1e-6, **SGPMC_BRANCHES["fused"])
    with temp_config(**numerics):
        jl = [dsd.SGPMCLayer.make(dsd.RBF.make(D), Z, 2,
                                  mean_function=dsd.Linear.make(
                                      rng.randn(D, 2) * 0.3), white=white),
              dsd.SGPMCLayer.make(dsd.RBF.make(2), rng.randn(6, 2), 1,
                                  white=white)]
        jm = dsd.DGPBase.make(X, Y, dsd.Gaussian.make(0.1), jl)
    jm = jm.replace(layers=[l.replace(q_mu=l.q_mu.with_value(
        rng.randn(*l.q_mu.value.shape))) for l in jm.layers])
    cfg = port.Config(dtype=torch.float64, **numerics)
    tl = [port.SGPMCLayer(port.RBF(D), Z, 2, port.Linear(np.zeros((D, 2))),
                          white=white, config=cfg),
          port.SGPMCLayer(port.RBF(2), Z[:, :2], 1, white=white, config=cfg)]
    tm = port.DGPBase.make(X, Y, port.Gaussian(0.1), tl, config=cfg,
                           device="cpu")
    return jm, port.load_reference_state(tm, _flat(jm))


def _heinonen_pair(rng):
    """DGPHeinonen (a GPMCLayer 2 -> 2 with an Identity mean on 12 fixed
    inputs, then GPR) in both packages, with a random q_mu."""
    Nh = 12
    X = np.sort(rng.uniform(-1, 1, (Nh, 2)), axis=0)
    Y = np.sin(2.5 * X[:, :1]) + 0.05 * rng.randn(Nh, 1)
    with temp_config(jitter=1e-6):
        jl = [dsd.GPMCLayer.make(dsd.RBF.make(2, lengthscales=0.6,
                                              variance=0.05), X, 2,
                                 dsd.Identity()),
              dsd.GPRLayer.make(dsd.RBF.make(2, lengthscales=0.6),
                                dsd.Zero(output_dim=1), 1)]
        jm = dsd.DGPHeinonen.make(X, Y, dsd.Gaussian.make(0.05 ** 2), jl)
    jm = jm.replace(layers=[jm.layers[0].replace(
        q_mu=jm.layers[0].q_mu.with_value(rng.randn(Nh, 2)))] + [
        jm.layers[1]])
    cfg = port.Config(dtype=torch.float64, jitter=1e-6)
    tl = [port.GPMCLayer(port.RBF(2), X, 2, port.Identity(), config=cfg),
          port.GPRLayer(port.RBF(2), port.Zero(1), 1, config=cfg)]
    tm = port.DGPHeinonen.make(X, Y, port.Gaussian(1.0), tl, config=cfg,
                               device="cpu")
    return jm, port.load_reference_state(tm, _flat(jm)), X


def _check_mcmc_models(rng, Xt):
    """SGPMCLayer on every branch, the SGPMC DGP and DGPHeinonen, their
    precompute and load_reference_state, against JAX at rtol 1e-9."""
    for white in (True, False):
        for branch in SGPMC_BRANCHES:
            _sgpmc_layer_case(rng, white, branch)
    X, Y = rng.randn(25, D), rng.randn(25, 1)
    zs = [rng.randn(S, N, 2), rng.randn(S, N, 1)]
    jzs = [jnp.asarray(z) for z in zs]
    for white in (True, False):
        case = f"SGPMC DGP white={white}"
        jm, tm = _sgpmc_dgp(rng, X, Y, white)
        assert not any("q_sqrt" in k for k in _flat(jm)), (
            f"{case}: a q_sqrt in the JAX state")
        want = _jax_predict_y(jm, jnp.asarray(Xt), jzs)
        live = tm.predict_y(Xt, S=S, zs=zs)
        cached = port.precompute(tm).predict_y(Xt, S=S, zs=zs)
        jcached = _jax_predict_y(dsd.precompute(jm), jnp.asarray(Xt), jzs)
        for what, a, b, c, d in zip(("mean", "var"), live, want, cached,
                                    jcached):
            _close9(f"{case} predict_y {what}", a, b)
            _close9(f"{case} precompute predict_y {what}", c, d)
            _close9(f"{case} cached vs live {what}", c, b)
    jm, tm, Xh = _heinonen_pair(rng)
    Xn = rng.uniform(-1, 1, (7, 2))
    _close9("GPMCLayer build_latents", tm.layers[0].build_latents(),
            jm.layers[0].build_latents())
    for full_cov in (False, True):
        jc = jm.layers[0].conditional_ND(jnp.asarray(Xn), full_cov=full_cov)
        tc = tm.layers[0].conditional_ND(torch.as_tensor(Xn),
                                         full_cov=full_cov)
        for what, a, b in zip(("mean", "var"), tc, jc):
            _close9(f"GPMCLayer conditional_ND full_cov={full_cov} {what}",
                    a, b)
    jlp, jg = jax.jit(jax.value_and_grad(lambda m: m.log_posterior()))(jm)
    lp = tm.log_posterior()
    lp.backward()
    _close9("DGPHeinonen log_posterior", lp, jlp)
    _grads_close("DGPHeinonen log_posterior", tm, jg,
                 dict(tm.named_parameters()))
    hzs = [rng.randn(S, 7, 2), rng.randn(S, 7, 1)]
    jhzs = [jnp.asarray(z) for z in hzs]
    live = tm.predict_y(Xn, S=S, zs=hzs)
    want = _jax_predict_y(jm.replace(layers=[
        jm.layers[0], jm._collapsed_last_layer()]), jnp.asarray(Xn), jhzs)
    cached = port.precompute(tm).predict_y(Xn, S=S, zs=hzs)
    jcached = _jax_predict_y(dsd.precompute(jm), jnp.asarray(Xn), jhzs)
    for what, a, b, c, d in zip(("mean", "var"), live, want, cached,
                                jcached):
        _close9(f"DGPHeinonen predict_y {what}", a, b)
        _close9(f"DGPHeinonen precompute predict_y {what}", c, d)
    state = _flat(jm)
    assert {"layers.0.X_fixed", "layers.0.Lu"} <= set(state), (
        "DGPHeinonen: the JAX state lacks the GPMC buffers")
    bad = dict(state, **{"layers.0.q_sqrt.unconstrained": np.eye(2)})
    try:
        port.load_reference_state(tm, bad)
    except KeyError:
        pass
    else:
        raise AssertionError("load_reference_state took an extra q_sqrt")


def _check_dynamic_and_export(rng, model, Xt, Yt):
    """DynamicPredictor's plan, first-S slicing against make_server at the
    bucket size, chunking above the largest bucket and its program counts;
    predict_density of a single-layer model against JAX's
    DynamicPredictor; the exported predict_y, live and precomputed,
    through torch.export.save / load against the live model."""
    from doubly_stochastic_dgp_tpu_torch.serving import predict_y_draws
    dp = port.DynamicPredictor(model)
    plans = {S_: dp._plan(S_) for S_ in (1, 5, 8, 25, 100, 128, 129, 300)}
    assert plans == {1: (1, 1), 5: (8, 1), 8: (8, 1), 25: (32, 1),
                     100: (128, 1), 128: (128, 1), 129: (128, 2),
                     300: (128, 3)}, f"DynamicPredictor plan {plans}"
    for S_ in (1, 5, 25, 100):
        B_ = dp._plan(S_)[0]
        got = dp.predict_y(Xt, S_, seed=7)
        want = port.make_server(model, B_, precompute=False)(Xt, seed=7)
        for what, a, b in zip(("mean", "var"), got, want):
            assert a.shape == (S_, N, 1) and torch.equal(a, b[:S_]), (
                f"DynamicPredictor S={S_} {what}: not the first S of "
                f"make_server's S={B_} request")
    dp.predict_y(Xt, 25, seed=8)
    assert dict(dp.trace_counts) == {("y", b): 1 for b in (1, 8, 32, 128)}, (
        f"DynamicPredictor programs {dict(dp.trace_counts)}")
    got = dp.predict_f(Xt, 300, seed=7)
    parts = [model.predict_f(Xt, S=128, generator=torch.Generator(
        ).manual_seed(port.serving.derive_seed(7, c))) for c in range(3)]
    for what, a, b in zip(("mean", "var"), got, zip(*parts)):
        assert torch.equal(a, torch.cat(b)[:300]), (
            f"DynamicPredictor chunked S=300 {what}")
    d = dp.predict_density(Xt, Yt, 25, seed=7)
    assert d.shape == (N, 1) and torch.isfinite(d).all(), "density shape"
    # single layer: the moments do not depend on the draws, so the
    # density equals JAX's exactly
    with temp_config(**FUSED):
        js = dsd.DGP.build(Xt, Yt, Xt[:5], [dsd.RBF.make(D)],
                           dsd.Gaussian.make(0.1))
    js = js.replace(layers=[js.layers[0].replace(
        q_mu=js.layers[0].q_mu.with_value(rng.randn(5, 1)))])
    ts = port.DGP.build(Xt, Yt, Xt[:5], [port.RBF(D)], port.Gaussian(1.0),
                        config=port.Config(**FUSED), device="cpu")
    port.load_reference_state(ts, _flat(js))
    want = dsd.DynamicPredictor(js).predict_density(jnp.asarray(Xt),
                                                    jnp.asarray(Yt), 5)
    _close9("DynamicPredictor single-layer predict_density",
            port.DynamicPredictor(ts).predict_density(Xt, Yt, 5), want)
    # export: the saved program against the live (and cached) model
    g = torch.Generator().manual_seed(3)
    zs = predict_y_draws(model, N, S, g)
    with tempfile.TemporaryDirectory() as tmp:
        for pre in (False, True):
            path = os.path.join(tmp, f"predict_y_{pre}.pt2")
            port.export_predict_y(model, N, S, path=path, precomputed=pre)
            call = port.load_exported(path)
            src = port.precompute(model) if pre else model
            want = src.predict_y(Xt, S=S, zs=zs)
            for what, a, b in zip(("mean", "var"),
                                  call(torch.as_tensor(Xt), zs), want):
                _close9(f"export precomputed={pre} {what}", a, b)
            ops = {str(n.target) for mod in call.program.graph_module.modules()
                   if hasattr(mod, "graph") for n in mod.graph.nodes}
            assert any("dsdgp.fused_conditional_fwd" in o for o in ops) or pre, (
                f"export: the program lacks the fused op: {sorted(ops)}")
        # refreshed parameters without a new export
        other = copy.deepcopy(model)
        with torch.no_grad():
            for p in other.parameters():
                p.mul_(1.01)
        for what, a, b in zip(("mean", "var"), call(
                torch.as_tensor(Xt), zs,
                state=port.precompute(other).state_dict()),
                port.precompute(other).predict_y(Xt, S=S, zs=zs)):
            _close9(f"export with refreshed parameters {what}", a, b)



# ---------------------------------------------------------------------------
# data parallelism: the port's steps, fit_dp, predictions and evaluation
# on gloo ranks (spawned CPU processes running tests/test_torch_ranks.py)
# against the port's own single-process functions, fed the union of the
# ranks' rows and the same draws (JAX's threefry draws cannot be
# reproduced here, so these comparisons are internal to the port)
# ---------------------------------------------------------------------------

RANKS_TIMEOUT_S = 240.0
DP_N, DP_D, DP_S, DP_BATCH = 12, 2, 2, 6


def _dp_model(rng, rows=DP_N, num_samples=DP_S, lik=None, outputs=1):
    X = rng.randn(rows, DP_D)
    Y = (np.sin(X[:, :1]) + 0.1 * rng.randn(rows, 1) if lik is None
         else rng.randint(0, outputs, (rows, 1)).astype(float))
    kernels = ([port.RBF(DP_D), port.RBF(DP_D, lengthscales=1.2)]
               if lik is None else [port.RBF(DP_D)])
    m = port.DGP.build(X, Y, X[:4], kernels, lik or port.Gaussian(0.1),
                       num_outputs=outputs, num_samples=num_samples,
                       config=port.Config(), device="cpu")
    for layer in m.layers:
        layer.q_mu.set_value(rng.randn(*layer.q_mu.value.shape) * 0.5)
    return m


def _union(per_rank, rows_per_rank):
    """Per step (minibatch indices, [normals a layer]) of one process:
    the ranks' recorded draws joined, the indices made global."""
    steps = []
    for draws in zip(*[_by_step(d) for d in per_rank]):
        idx = np.concatenate([r * rows_per_rank + d[0]
                              for r, d in enumerate(draws)])
        zs = [np.concatenate([d[1][l] for d in draws], axis=1)
              for l in range(len(draws[0][1]))]
        steps.append((idx, zs))
    return steps


def _by_step(draws):
    out = []
    for kind, a in draws:
        if kind == "randint":
            out.append((a, []))
        else:
            out[-1][1].append(a)
    return out


def _single_steps(model, steps, **adam):
    opt = port_masked_optimizer(model, LR, **adam)
    step = make_sgd_train_step(opt)
    losses = [float(step(model, idx=torch.as_tensor(idx), zs=zs))
              for idx, zs in steps]
    return losses


def _params_close(case, got, model, rtol=1e-9, atol=1e-12):
    for name, p in model.named_parameters():
        assert_allclose(got[name], p.detach().numpy(), rtol=rtol, atol=atol,
                        err_msg=f"{case}: {name}")


def _seed_draws(seed, n, rows, widths, steps, batch, S=DP_S):
    """The draws of ``fit_dp``'s ranks (rank r from rank_generator(seed,
    r): per step its minibatch indices, then the normals a layer) in the
    recorded form."""
    from doubly_stochastic_dgp_tpu_torch.parallel.mesh import rank_generator
    per_rank = []
    for r in range(n):
        g = rank_generator(seed, r, "cpu")
        draws = []
        for _ in range(steps):
            draws.append(("randint", torch.randint(
                0, rows // n, (batch // n,), generator=g).numpy()))
            draws += [("randn", torch.randn(
                (S, batch // n, d), generator=g,
                dtype=torch.float64).numpy()) for d in widths]
        per_rank.append(draws)
    return per_rank


def _check_data_parallel(rng):
    """On 2 gloo ranks: a chunk of make_dp_scan_train_step (plain, guarded,
    grad_inside=False), make_dp_train_step and make_dp_natgrad_adam_step
    (a padded 7-row batch) and fit_dp (3 steps at batch 6) against the
    single-process steps on the same rows and draws; fit_dp's checkpoint
    resume bit for bit; fit_dp on a (data 1 x sample 2) mesh against
    fit; dp_predict_y and dp_predict_density (fixed and seeded draws),
    dp_evaluate_regression (7 rows, padded; fixed and seeded draws) and
    dp_evaluate_classification against the single-process functions;
    the JAX functions' refusals (exception types) and fit_dp's guard
    warnings; and on 1 rank, fit_dp against fit bit for bit (plain and
    guarded)."""
    import pickle
    import shutil
    from concurrent.futures import ThreadPoolExecutor
    import test_torch_ranks as ranks
    from doubly_stochastic_dgp_tpu_torch.parallel.mesh import run_ranks

    model = _dp_model(rng)
    fresh = lambda: pickle.loads(pickle.dumps(model))        # noqa: E731
    Xs, Ys = rng.randn(7, DP_D), rng.randn(7, 1)
    widths = (DP_D, 1)
    clf = _dp_model(rng, lik=port.MultiClass(3), outputs=3)
    ckpt = tempfile.mkdtemp(prefix="dsdgp_fit_dp_")
    payload = {
        "model": pickle.dumps(model), "batch": DP_BATCH,
        "X_b": model.X_data[:7].numpy(), "Y_b": model.Y_data[:7].numpy(),
        "zs_b": [rng.randn(DP_S, 7, d) for d in widths],
        "zs_b2": [rng.randn(DP_S, 7, d) for d in widths],
        "ckpt_dir": ckpt, "Xs": Xs, "Ys": Ys, "S": 4,
        "zs_pred": [rng.randn(4, 7, d) for d in widths],
        "zs_eval": [rng.randn(4, 7, d) for d in widths],
        "Y_std": np.array([1.3]), "classifier": pickle.dumps(clf),
        "Xc": clf.X_data[:7].numpy(), "Yc": clf.Y_data[:7].numpy(),
        "zs_c": [rng.randn(4, 7, 3)],
        "collapsed": pickle.dumps(port.DGPCollapsed.build(
            Xs[:6], Ys[:6], Xs[:3], [port.RBF(DP_D)], port.Gaussian(0.1),
            device="cpu")),
        "odd": pickle.dumps(_dp_model(rng, rows=13)),
        "s3": pickle.dumps(_dp_model(rng, num_samples=3))}
    # the two groups at once
    pool = ThreadPoolExecutor(2)
    runs = [pool.submit(run_ranks, fn, n, (payload,), device="cpu",
                        threads=1, timeout_s=RANKS_TIMEOUT_S)
            for fn, n in ((ranks.paths_ranks, 2), (ranks.fit_one_rank, 1))]
    pool.shutdown(wait=False)
    try:
        res, (one,) = (r.result() for r in runs)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    out = res[0]
    for key in out:
        a, b = out[key], res[1][key]
        if key.startswith("scan"):
            a, b = a[:2], b[:2]          # the ranks' draws differ
        if key == "fit_dp":              # and their clocks
            a, b = ([a[0]] + [(h["iter"], h["loss"]) for h in a[1]],
                    [b[0]] + [(h["iter"], h["loss"]) for h in b[1]])
        assert pickle.dumps(a) == pickle.dumps(b), (
            f"data parallel {key}: the ranks disagree")

    for case in ("plain", "guarded", "grad outside"):
        loss, params, _, dispatch = out[f"scan {case}"]
        assert dispatch == "eager", f"scan {case}: dispatch {dispatch}"
        single = fresh()
        losses = _single_steps(single, _union(
            [r[f"scan {case}"][2] for r in res], DP_N // 2)[:2])
        assert_allclose(loss, np.mean(losses), rtol=1e-10,
                        err_msg=f"make_dp_scan_train_step {case}: loss")
        _params_close(f"make_dp_scan_train_step {case}", params, single)

    single = fresh()
    opt = port_masked_optimizer(single, LR)
    port.make_train_step(lambda m: -(m.elbo(
        payload["X_b"], payload["Y_b"], zs=payload["zs_b"])
        + port.log_prior(m)), opt)(single)
    _params_close("make_dp_train_step (7 rows, padded)",
                  out["train step"][1], single)
    single = fresh()
    opt = port_masked_optimizer(single, LR,
                                freeze=port_freeze_q_params((-1,), 2))
    step = port.make_natgrad_adam_step(opt, 0.1)
    loss = step(single, idx=torch.arange(7),
                zs=(payload["zs_b"], payload["zs_b2"]))
    nat_loss, params, rejected = out["natgrad step"]
    assert rejected == int(step.rejected) == 0, "natgrad step: rejected"
    assert_allclose(nat_loss, float(loss), rtol=1e-10,
                    err_msg="make_dp_natgrad_adam_step: loss")
    _params_close("make_dp_natgrad_adam_step", params, single)

    params, hist = out["fit_dp"]
    single = fresh()
    losses = _single_steps(single, _union(_seed_draws(
        4, 2, DP_N, widths, 3, DP_BATCH), DP_N // 2))
    _params_close("fit_dp (2 ranks, 3 steps)", params, single)
    assert [h["iter"] for h in hist] == [1, 2, 3] and all(
        h["dispatch"] == "eager" for h in hist), f"fit_dp history {hist}"
    assert_allclose([h["loss"] for h in hist], losses, rtol=1e-10,
                    err_msg="fit_dp: history losses")
    for name in params:
        assert np.array_equal(out["fit_dp resumed"][name], params[name]), (
            f"fit_dp checkpoint resume: {name} not bit for bit")
    single = fresh()
    port.fit(single, 2, learning_rate=LR, batch_size=DP_BATCH, seed=6,
             log_every=2, scan_steps=2)
    _params_close("fit_dp on a (data 1 x sample 2) mesh vs fit",
                  out["fit_dp sample axis"], single)

    m = fresh()
    mean, var = m.predict_y(Xs, 4, zs=payload["zs_pred"])
    gen = torch.Generator().manual_seed(9)
    mean9, var9 = m.predict_y(Xs, 4, generator=gen)
    for case, (pm, pv), (m_, v_) in (("zs", out["predict_y zs"], (mean, var)),
                                     ("seed", out["predict_y seed"],
                                      (mean9, var9))):
        want_m = m_.mean(0)
        want_v = (v_ + m_ ** 2).mean(0) - want_m ** 2
        assert_allclose(pm, want_m.numpy(), rtol=1e-10, atol=1e-12,
                        err_msg=f"dp_predict_y {case}: mean")
        assert_allclose(pv, want_v.numpy(), rtol=1e-10, atol=1e-12,
                        err_msg=f"dp_predict_y {case}: variance")
    assert_allclose(out["predict_density zs"], m.predict_density(
        Xs, Ys, 4, zs=payload["zs_pred"]).numpy(), rtol=1e-10,
        err_msg="dp_predict_density")
    want = port.evaluate_regression(m, Xs, Ys, payload["Y_std"], 4,
                                    zs=payload["zs_eval"])
    # seeded: rank r predicts its 4 rows (7 padded to 8) with the normals
    # of rank_generator(2, r), a layer at a time
    from doubly_stochastic_dgp_tpu_torch.parallel.mesh import rank_generator
    gens = [rank_generator(2, r, "cpu") for r in range(2)]
    zs2 = [torch.cat([torch.randn((4, 4, d), generator=g,
                                  dtype=torch.float64) for g in gens],
                     dim=1)[:, :7] for d in widths]
    want2 = port.evaluate_regression(m, Xs, Ys, payload["Y_std"], 4,
                                     zs=zs2)
    for case, got, w in (("zs", out["evaluate_regression"], want),
                         ("seed", out["evaluate_regression seed"], want2)):
        for k in ("rmse", "nll", "loglik"):
            assert_allclose(got[k], w[k], rtol=1e-10,
                            err_msg=f"dp_evaluate_regression {case}: {k}")
    want = port.evaluate_classification(clf, payload["Xc"], payload["Yc"],
                                        4, zs=payload["zs_c"])
    for k in ("accuracy", "loglik", "nll"):
        assert_allclose(out["evaluate_classification"][k], want[k],
                        rtol=1e-10,
                        err_msg=f"dp_evaluate_classification: {k}")

    for key, exc, text in (
            ("fit_dp collapsed", "ValueError", "collapsed"),
            ("fit_dp odd N", "ValueError", "must divide"),
            ("sp_elbo S=3", "ValueError", "num_samples=3 must divide"),
            ("dp_predict_y S=3", "AssertionError", "S=3 must divide"),
            ("guard grad outside", "ValueError", "grad_inside=True")):
        assert out[key] is not None and out[key][0] == exc and (
            text in out[key][1]), f"{key}: raised {out[key]}, want {exc}"
    for text in ("raising scan_steps from 2 to 8",
                 "not implemented for the composed data x sample step"):
        assert any(text in w for w in out["warnings"]), (
            f"fit_dp warnings {out['warnings']}: no {text!r}")

    for guard in (False, True):
        single = fresh()
        _, hist = port.fit(single, 16, learning_rate=LR,
                           batch_size=DP_BATCH, seed=3, log_every=8,
                           reject_nonfinite=guard)
        params, losses = one[guard]
        assert losses == [h["loss"] for h in hist], (
            f"fit_dp on 1 rank (guard {guard}): losses differ from fit's")
        for name, p in single.named_parameters():
            assert np.array_equal(params[name], p.detach().numpy()), (
                f"fit_dp on 1 rank (guard {guard}): {name} not bit for "
                f"bit fit's")


def _close(case, got, want):
    assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL,
                    atol=ATOL, err_msg=case)


# the torch demos (demos_torch/): each runs in-process on the CPU, and
# each one's model before training gives the JAX demo's summary table

# tests/test_demos.py:24-41's arguments; run_regression, uci_benchmark and
# collapsed are not in that list and run at small sizes of their own
DEMO_RUNS = [
    ("step_function", ["--iterations", "40", "--num-samples", "5"]),
    ("priors", ["--frames", "2"]),
    ("natural_gradients", ["--iterations", "20"]),
    ("mnist", ["--synthetic", "--iterations", "5", "--minibatch", "128"]),
    ("damianou", ["--n", "120", "--iterations", "15", "--inducing", "12"]),
    ("sgpmc", ["--num-data", "30", "--num-inducing", "8", "--num-samples",
               "60", "--num-burn", "40"]),
    ("sgpmc", ["--sampler", "nuts", "--max-depth", "5", "--num-data", "30",
               "--num-inducing", "8", "--num-samples", "60", "--num-burn",
               "40"]),
    ("serving", ["--num-data", "60", "--iterations", "30", "--batch", "16",
                 "--num-samples", "3"]),
    ("run_regression", ["kin8nm", "2", "0", "--synthetic", "--iterations",
                        "10", "--log-every", "10", "--minibatch", "1000"]),
    ("uci_benchmark", ["--iterations", "10", "--max-layers", "2",
                       "--num-inducing", "20", "--eval-samples", "5"]),
    ("collapsed", ["--iterations", "30"]),
]
_EVAL = ["rmse", "nll", "loglik"]    # evaluate_regression's keys
# the keys of the JSON each JAX demo prints, at its json.dumps line
DEMO_KEYS = {
    "step_function": ["final_loss", "layers"],          # :51-61
    "priors": ["frames", "sample_range", "frame_to_frame_rms"],   # :63
    "natural_gradients": ["adam_only_loss", "natgrad_adam_loss",
                          "natgrad_better_by"],         # :44
    "mnist": ["accuracy", "test_loglik", "layers", "final_loss"],  # :126
    "damianou": _EVAL + ["label", "seconds", "final_loss"],  # :107, :138
    "sgpmc": ["sampler", "accept_rate", "adapted_step_size", "ess_min",
              "ess_median", "posterior_mean_rmse_vs_truth",
              "truth_coverage_95"],                     # :100
    "sgpmc nuts": ["sampler", "accept_rate", "adapted_step_size", "ess_min",
                   "ess_median", "posterior_mean_rmse_vs_truth",
                   "truth_coverage_95", "mean_tree_depth",
                   "divergences"],                      # :100, :88-90
    "serving": ["precomputed", "artifact_bytes", "batch", "S",
                "served_shape", "server_matches_inprocess_bitwise",
                "max_abs_diff",
                "make_server_max_abs_diff_vs_artifact"],  # :139
    "run_regression": ["dataset", "L", "split"] + _EVAL,  # :112
    "uci_benchmark": ["dataset", "real_data", "results"],  # :128
    "collapsed": ["collapsed_bound_init", "collapsed_bound_trained",
                  "quad_bound_after_one_natgrad_step",
                  "identity_gap"],                      # :79-85
}
STEP_LAYER_KEYS = ["layer", "sample_mean_range", "sample_std_max"]  # :54-57
ACCELERATOR = dict(float_dtype="float32", jitter=1e-5, solve_mode="inverse",
                   matmul_precision="highest")


def _jax_demo(name):
    """The JAX demo's module (demos/<name>.py), for its data functions."""
    import importlib.util
    path = os.path.join(os.path.dirname(__file__), "..", "demos",
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"jax_demo_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_q_sqrt_scaled(m, layers):
    """The JAX demos' near-deterministic inner layers
    (demos/run_regression.py:88-93, uci_benchmark.py:110-114)."""
    ls = list(m.layers)
    for i in layers:
        ls[i] = ls[i].replace(q_sqrt=ls[i].q_sqrt.with_value(
            ls[i].q_sqrt.value * 1e-5))
    return m.replace(layers=ls)


def _jax_stack(D, L):
    """RBF(D) + White(D, 2e-6, frozen) inner kernels, RBF(D) last
    (demos/run_regression.py:76-82)."""
    kernels = []
    for l in range(L):
        k = dsd.RBF.make(D)
        if l < L - 1:
            k = k + dsd.White.make(D, variance=2e-6, trainable=False)
        kernels.append(k)
    return kernels


def _jax_demo_models(name, args, data):
    """[(label, JAX model)] built by the JAX demo's own lines (cited) from
    the torch demo's data, under the JAX demo's numerics."""
    X, Y, Z = data["X"], data["Y"], data["Z"]
    D = X.shape[1]
    if name == "run_regression":             # :51-57, :76-93
        with temp_config(**ACCELERATOR):
            m = dsd.DGP.build(X, Y, Z, _jax_stack(D, args.L),
                              dsd.Gaussian.make(0.05), num_samples=1)
            return [("", _jax_q_sqrt_scaled(m, range(args.L - 1)))]
    if name == "step_function":              # :40-44
        kernels = [dsd.RBF.make(1, lengthscales=0.2)
                   for _ in range(args.layers)]
        return [("", dsd.DGP.build(X, Y, Z, kernels, dsd.Gaussian.make(0.01),
                                   num_samples=args.num_samples))]
    if name == "natural_gradients":          # :33-37
        kernels = [dsd.RBF.make(1, lengthscales=0.3),
                   dsd.RBF.make(1, lengthscales=0.3)]
        return [("", dsd.DGP.build(X, Y, Z, kernels, dsd.Gaussian.make(0.05),
                                   num_samples=5))]
    if name == "priors":                     # :36, :38-44
        with temp_config(jitter=1e-4):
            kernels = [dsd.RBF.make(1, lengthscales=0.3)
                       for _ in range(args.layers)]
            return [("", dsd.DGP.build(X, X, Z, kernels,
                                       dsd.Gaussian.make(0.01),
                                       num_samples=1))]
    if name == "mnist":                      # :51-54, :71-79
        with temp_config(**ACCELERATOR):
            dims = [D] + [30] * (args.layers - 1)
            kernels = [dsd.RBF.make(d, lengthscales=2.0, variance=2.0)
                       for d in dims]
            return [("", dsd.DGP.build(X, Y, Z, kernels,
                                       dsd.MultiClass.make(10),
                                       num_outputs=10, num_samples=1))]
    if name == "uci_benchmark":              # :43-46, :83-117
        with temp_config(**ACCELERATOR):
            out = [("SGPR", dsd.SGPR.build(X, Y, dsd.RBF.make(D), Z.copy(),
                                           noise_variance=0.01)),
                   ("FITC", dsd.GPRFITC.build(X, Y, dsd.RBF.make(D),
                                              Z.copy(), noise_variance=0.01)),
                   ("SVGP", dsd.SVGP.build(X, Y, dsd.RBF.make(D),
                                           dsd.Gaussian.make(0.01),
                                           Z.copy()))]
            for L in range(1, args.max_layers + 1):
                m = dsd.DGP.build(X, Y, Z.copy(), _jax_stack(D, L),
                                  dsd.Gaussian.make(0.05), num_samples=1)
                out.append((f"DGP{L}", _jax_q_sqrt_scaled(m, range(L - 1))))
            return out
    if name == "collapsed":                  # :31-32, :45-50
        with temp_config(float_dtype="float64", jitter=1e-10):
            kerns = [dsd.RBF.make(D, lengthscales=0.4),
                     dsd.RBF.make(D, lengthscales=0.4)]
            layers = dsd.init_layers_linear(X, Y, Z, kerns)
            last = JSGPRLayer.make(layers[-1].kern,
                                   np.asarray(layers[-1].Z.value), 1,
                                   layers[-1].mean_function)
            return [("", dsd.DGPCollapsed.make(X, Y, dsd.Gaussian.make(0.05),
                                               layers[:-1] + [last]))]
    if name == "damianou":                   # :68-70 (off the accelerator)
        with temp_config(float_dtype="float64", jitter=1e-8):
            lay = JSGPRLayer.make(dsd.RBF.make(D), Z, Y.shape[1],
                                  dsd.Zero(output_dim=Y.shape[1]))
            m_sgpr = dsd.DGPCollapsed.make(X, Y, dsd.Gaussian.make(0.05),
                                           [lay])      # :113-116
            m_dam = dsd.DGPDamianou.build(X, Y, Z, [dsd.RBF.make(D),
                                                    dsd.RBF.make(D)],
                                          dsd.Gaussian.make(0.05))  # :119-121
            m_dgp = dsd.DGP.build(X, Y, Z, _jax_stack(D, 2),
                                  dsd.Gaussian.make(0.05),
                                  num_samples=5)       # :124-136
            return [("SGPR (collapsed, 1 layer)", m_sgpr),
                    ("DGPDamianou (2 layers)", m_dam),
                    ("DGP2 (doubly stochastic MC)",
                     _jax_q_sqrt_scaled(m_dgp, [0]))]
    if name == "sgpmc":                      # :61-64
        layer = dsd.SGPMCLayer.make(dsd.RBF.make(1, lengthscales=0.4), Z, 1,
                                    white=True)
        return [("", dsd.DGPBase.make(X, Y, dsd.Gaussian.make(0.05), [layer],
                                      num_samples=1))]
    if name == "serving":                    # :82-85
        return [("", dsd.DGP.build(X, Y, X[:20].copy(),
                                   [dsd.RBF.make(D), dsd.RBF.make(D)],
                                   dsd.Gaussian.make(0.05), num_samples=3))]
    raise KeyError(name)


def _demo_data(name, mod, args, mnist_data):
    """The torch demo's data and config, with the data checked against
    the JAX demo's own generator where it has one; ``mnist_data``: the
    mnist demo's (its kmeans takes seconds)."""
    if name == "mnist":
        data = mnist_data
        want = _jax_demo("mnist").synthetic_multiclass()
        for got, w in zip((data["X"], data["Y"], data["Xs"], data["Ys"]),
                          want):
            assert np.array_equal(got, w.astype(got.dtype)), (
                "demo mnist: data differ from demos/mnist.py's")
        return data, mod.ACCELERATOR
    if name == "step_function":
        data = mod.make_data(args)
        for got, w in zip((data["X"], data["Y"]),
                          _jax_demo("step_function").make_step_data()):
            assert np.array_equal(got, w), (
                "demo step_function: data differ from demos/"
                "step_function.py's")
        return data, port.Config()
    if name == "damianou":
        cfg = mod.config_of(args, torch.device("cpu"))
        return mod.make_data(args, cfg), cfg
    if name in ("run_regression", "priors", "collapsed"):
        return mod.make_data(args), mod.config_of(args)
    if name == "uci_benchmark":
        return mod.make_data(args), mod.ACCELERATOR
    return mod.make_data(args), port.Config()


def _check_demo_build(name, mod, args, mnist_data):
    """summary(build) of the torch demo against summary of the model the
    JAX demo's lines build from the same numpy data."""
    from test_torch_conditional import _same_table

    data, cfg = _demo_data(name, mod, args, mnist_data)
    built = mod.build(args, data, cfg, torch.device("cpu"))
    if not isinstance(built, list):
        built = [("", built)]
    want = _jax_demo_models(name, args, data)
    assert [l for l, _ in built] == [l for l, _ in want], (
        f"demo {name}: models {[l for l, _ in built]}")
    for (label, tm), (_, jm) in zip(built, want):
        _same_table(f"demo {name} {label}".strip(), port.summary(tm),
                    dsd.summary(jm))


def _check_demo_keys(case, got, keys):
    from demos_torch._common import numbers
    assert list(got) == keys, f"demo {case}: keys {list(got)}, not {keys}"
    bad = [x for x in numbers(got) if not np.isfinite(x)]
    assert not bad, f"demo {case}: non-finite values {got}"


def _check_demos():
    """Every torch demo in-process on the CPU: it returns the JAX demo's
    keys with finite values, and its build gives the JAX demo's summary
    table; mnist --data-parallel on two gloo ranks, whose results agree;
    and without a card a demo raises unless given --device cpu."""
    import importlib
    from concurrent.futures import ThreadPoolExecutor
    import test_torch_ranks as ranks
    from doubly_stochastic_dgp_tpu_torch.parallel.mesh import run_ranks

    mods = {name: importlib.import_module(f"demos_torch.{name}")
            for name, _ in DEMO_RUNS}
    mnist_argv = DEMO_RUNS[3][1] + ["--device", "cpu", "--data-parallel"]
    mnist_data = mods["mnist"].make_data(mods["mnist"].parse_args(
        mnist_argv))
    payload = {"argv": mnist_argv, "data": mnist_data}
    # one BLAS thread a rank (a spawned rank's numpy would start one a
    # core, and two ranks' SVDs then take ten times as long), set before
    # the ranks start and restored after they end
    blas = mock.patch.dict(os.environ, {k: "1" for k in (
        "OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")})
    blas.start()
    pool = ThreadPoolExecutor(1)
    dp = pool.submit(run_ranks, ranks.mnist_demo_ranks, 2, (payload,),
                     device="cpu", threads=1, timeout_s=240.0)
    pool.shutdown(wait=False)
    # two torch threads here: the demos' small ops spend more CPU waking
    # threads than computing (on 8 cores: 51 s of wall and 103 s of CPU,
    # against 60 s and 253 s at 8 threads), and the suite runs files side
    # by side
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        _run_demos(mods, mnist_data)
    finally:
        torch.set_num_threads(threads)
        two = dp.result()
        blas.stop()
    assert two[0] == two[1], f"mnist --data-parallel: the ranks disagree {two}"
    _check_demo_keys("mnist --data-parallel on 2 gloo ranks", two[0],
                     DEMO_KEYS["mnist"])


def _run_demos(mods, mnist_data):
    """Each demo of DEMO_RUNS through its main on the CPU: its keys and
    finite values, and its build against the JAX demo's; and a demo
    without a card and without --device cpu raises."""
    with tempfile.TemporaryDirectory() as tmp:
        for name, argv in DEMO_RUNS:
            argv = argv + ["--device", "cpu"]
            if name == "run_regression":
                argv += ["--results", tmp]
            case = f"{name} {' '.join(argv)}"
            with contextlib.redirect_stdout(io.StringIO()):
                # mnist takes the data made once above (its kmeans over
                # 6000 x 784 rows takes seconds)
                out = (mods[name].main(argv, mnist_data) if name == "mnist"
                       else mods[name].main(argv))
            key = "sgpmc nuts" if "nuts" in argv else name
            if name == "damianou":
                assert len(out) == 3, f"demo {case}: {len(out)} results"
                for res in out:
                    _check_demo_keys(case, res, DEMO_KEYS[key])
            else:
                _check_demo_keys(case, out, DEMO_KEYS[key])
            if name == "step_function":
                for layer in out["layers"]:
                    assert list(layer) == STEP_LAYER_KEYS, f"demo {case}"
            if name == "uci_benchmark":
                assert list(out["results"]) == [
                    "SGPR", "FITC", "SVGP", "DGP1", "DGP2"], f"demo {case}"
                for res in out["results"].values():
                    assert list(res) == ["loglik", "rmse"], f"demo {case}"
            if name == "serving":
                assert out["server_matches_inprocess_bitwise"], case
            if "nuts" not in argv:
                _check_demo_build(name, mods[name], mods[name].parse_args(
                    argv), mnist_data)
    if not torch.cuda.is_available():
        try:
            mods["priors"].main(["--frames", "1"])
        except RuntimeError as e:
            assert "device='cpu'" in str(e), f"demo priors without a card: {e}"
        else:
            raise AssertionError("demo priors ran without a card and "
                                 "without --device cpu")


def test_paths_match_jax():
    fused_conditional.launches = fused_conditional.backward_launches = 0
    rng = np.random.RandomState(0)
    X, Y = rng.randn(60, D), rng.randn(60, 1)
    Xt, Yt = rng.randn(N, D), rng.randn(N, 1)
    jmodel = _jax_model(rng, X, Y)
    model = _port_model(X, Y, jmodel)
    assert isinstance(model.layers[0].mean_function, port.Linear), (
        "setup: the narrowing layer has no PCA Linear mean function")

    # propagate with the same fixed draws: every layer's F, mean, var
    zs = [rng.randn(S, N, d) for d in (H, H, 1)]
    jF, jm, jv = jmodel.propagate(jnp.asarray(Xt), S=S,
                                  zs=[jnp.asarray(z) for z in zs])
    tF, tm, tv = model.propagate(Xt, S=S, zs=zs)
    for l in range(3):
        for what, got, want in (("F", tF, jF), ("mean", tm, jm),
                                ("var", tv, jv)):
            _close(f"propagate layer {l} {what}", got[l], want[l])

    # predict_y moments and the predict_density logsumexp at those draws
    jy = jmodel.likelihood.predict_mean_and_var(jm[-1], jv[-1])
    ty = model.predict_y(Xt, S=S, zs=zs)
    for what, got, want in zip(("mean", "var"), ty, jy):
        _close(f"predict_y {what}", got, want)
    jl = jmodel.likelihood.predict_density(jm[-1], jv[-1], jnp.asarray(Yt))
    jd = logsumexp(jl - jnp.log(S), axis=0)
    _close("predict_density", model.predict_density(Xt, Yt, S=S, zs=zs), jd)

    # the port's server: live (fused branch) vs cached at one seed
    live = port.make_server(model, S=S, precompute=False)
    cached = port.make_server(model, S=S, precompute=True)
    for what, a, b in zip(("mean", "var"), live(Xt, seed=11),
                          cached(Xt, seed=11)):
        assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL,
                        err_msg=f"live vs cached server {what}")
    d_live = port.make_server(model, S=S, precompute=False,
                              method="predict_density")(Xt, Yt, seed=11)
    assert d_live.shape == (N, 1), f"density server shape {d_live.shape}"

    # bucket padding keeps the request's rows: a 7-row request padded to
    # the 8-row bucket equals the unbucketed server on the padded input
    bucketed = port.make_server(model, S=S, precompute=False,
                                batch_buckets=(8, 16))
    plain = port.make_server(model, S=S, precompute=False)
    Xp = np.concatenate([Xt[:7], np.zeros((1, D))])
    for what, a, b in zip(("mean", "var"), bucketed(Xt[:7], seed=5),
                          plain(Xp, seed=5)):
        assert a.shape == (S, 7, 1), f"bucket padding {what} shape {a.shape}"
        assert torch.equal(a, b[:, :7]), f"bucket padding {what} rows"

    # a 30-row request spans two top-bucket chunks; each chunk draws from
    # the seed derived from (seed, chunk index)
    a = bucketed(Xt, seed=5)
    first = plain(Xt[:16], seed=port.serving.derive_seed(5, 0))
    second = plain(np.concatenate([Xt[16:], np.zeros((2, D))]),
                   seed=port.serving.derive_seed(5, 1))
    assert a[0].shape == (S, N, 1), f"chunked shape {a[0].shape}"
    assert torch.equal(a[0], torch.cat([first[0], second[0][:, :14]], 1)), (
        "chunked request: rows differ from per-chunk calls")

    # pinned seeds reproduce bit for bit; unpinned requests differ
    for name, serve in (("live", live), ("cached", cached),
                        ("bucketed", bucketed)):
        r1, r2 = serve(Xt, seed=3), serve(Xt, seed=3)
        assert all(torch.equal(p, q) for p, q in zip(r1, r2)), (
            f"{name}: pinned seed not reproducible")
        u1, u2 = serve(Xt), serve(Xt)
        assert not torch.equal(u1[0], u2[0]), (
            f"{name}: successive unpinned requests drew the same samples")
        assert all(torch.isfinite(t).all() for t in r1), f"{name}: non-finite"

    _check_training(rng, X, Y, jmodel)
    _check_no_host_reads(X, Y, jmodel, Xt)
    # its own stream, so that the cases after it keep their draws
    _check_default_config(np.random.RandomState(6), X, Y, Xt, Yt)
    _check_guard(rng)
    _check_evaluate_regression(rng, X, Y, Xt, Yt)
    # its own stream, so that the cases after it keep their draws
    _check_classification(np.random.RandomState(7))
    # their own streams, so that the cases before them keep their draws
    _check_quad(np.random.RandomState(41))
    _check_heteroscedastic(np.random.RandomState(42), Xt, Yt)
    _check_input_prop(np.random.RandomState(43), Xt)
    _check_gamma1_identities()
    _check_lbfgs(np.random.RandomState(45))
    _check_mcmc_models(np.random.RandomState(46), Xt)
    _check_dynamic_and_export(np.random.RandomState(47), model, Xt, Yt)
    _check_data_parallel(np.random.RandomState(48))
    _check_demos()
    psi2_core.launches = 0
    _check_collapsed(rng, Xt, Yt)
    assert (fused_conditional.launches, fused_conditional.backward_launches,
            psi2_core.launches) == (0, 0, 0), (
        "a CUDA kernel was launched for CPU tensors")
