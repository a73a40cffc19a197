"""PyTorch port: the serving path of a 3-layer DGP against the JAX package
in float64 on the CPU, and the port's server semantics.

The model (D=5 narrowing to a hidden width of 3, so a PCA Linear mean
function is exercised; M=20) is built in JAX with ``use_pallas=True``
and a randomised posterior, and carried over with
``load_reference_state``.  Random streams differ between the packages,
so the parity runs through fixed draws ``zs``.  One test item that names
the failing case in every assertion message."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.scipy.special import logsumexp
from numpy.testing import assert_allclose

import doubly_stochastic_dgp_tpu as dsd
from doubly_stochastic_dgp_tpu.config import temp_config
import doubly_stochastic_dgp_tpu_torch as port

RTOL, ATOL = 1e-8, 1e-10
S, N, D, M, H = 4, 30, 5, 20, 3


def _jax_model(rng, X, Y):
    Z = X[:M]
    with temp_config(use_pallas=True, solve_mode="inverse", jitter=1e-6):
        kernels = [dsd.RBF.make(D) + dsd.White.make(D, variance=2e-6),
                   dsd.RBF.make(H, lengthscales=1.3)
                   + dsd.White.make(H, variance=2e-6),
                   dsd.RBF.make(H, variance=0.9)]
        model = dsd.DGP.build(X, Y, Z, kernels, dsd.Gaussian.make(0.05))
    layers = []
    for layer in model.layers:
        Mi, Do = layer.q_mu.value.shape
        q_sqrt = np.tril(rng.randn(Do, Mi, Mi) * 0.2) + 0.3 * np.eye(Mi)
        layers.append(layer.replace(
            q_mu=layer.q_mu.with_value(rng.randn(Mi, Do)),
            q_sqrt=layer.q_sqrt.with_value(q_sqrt)))
    return model.replace(layers=layers)


def _port_model(X, Y, jmodel):
    kernels = [port.RBF(D) + port.White(D), port.RBF(H) + port.White(H),
               port.RBF(H)]
    cfg = port.Config(use_pallas=True, solve_mode="inverse", jitter=1e-6)
    model = port.DGP.build(X, Y, X[:M], kernels, port.Gaussian(1.0),
                           config=cfg, device="cpu")
    state = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
             jax.tree_util.tree_flatten_with_path(jmodel)[0]}
    return port.load_reference_state(model, state)


def _close(case, got, want):
    assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL,
                    atol=ATOL, err_msg=case)


def test_serving_path_matches_jax():
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
