"""The plain reference at tiny sizes in float64: one layer against the
exact GP posterior, the robust-max quadrature against a long Monte-Carlo
sum and its limits, the Gaussian expectation in closed form against
Monte Carlo, the KL against its dense formula, and Adam against optax's
formula written out."""

import math

import numpy as np
import pytest
import torch

from benchmark.reference import dgp as ref
from benchmark.reference.draws import derive_seed

CONFIG = {"input_dim": 2, "hidden_dims": [], "num_outputs": 1,
          "num_inducing": 12, "inner_white_variance": 0.0,
          "kernel": {"variance": 1.3, "lengthscales": 0.7},
          "likelihood": {"type": "Gaussian", "variance": 0.1},
          "numerics": {"jitter": 1e-12}}


def _gp_case(seed=0, n=12, m=5):
    g = torch.Generator().manual_seed(seed)
    X = torch.rand(n, 2, generator=g, dtype=torch.float64) * 3
    Xs = torch.rand(m, 2, generator=g, dtype=torch.float64) * 3
    y = torch.sin(X.sum(1, keepdim=True)) + 0.1 * torch.randn(
        n, 1, generator=g, dtype=torch.float64)
    return X, Xs, y


def test_one_layer_is_the_exact_gp_posterior():
    """q(u) at Z = X set to the exact posterior of f(X) | y: the
    conditional at new inputs is the exact GP posterior."""
    X, Xs, y = _gp_case()
    params, frozen = ref.init_params(CONFIG, X, X)
    ls = torch.full((2,), 0.7, dtype=torch.float64)
    K = ref.rbf(X, X, ls, torch.tensor(1.3, dtype=torch.float64))
    A = K + 0.1 * torch.eye(12, dtype=torch.float64)
    m = K @ torch.linalg.solve(A, y)
    S = K - K @ torch.linalg.solve(A, K)
    with torch.no_grad():
        params["layers.0.q_mu"].copy_(m)
        params["layers.0.q_sqrt"].copy_(torch.linalg.cholesky(
            S + 1e-12 * torch.eye(12, dtype=torch.float64))[None])
    mean, var = ref.conditional(CONFIG, params, frozen, 0, Xs, block=2)
    Ks = ref.rbf(Xs, X, ls, torch.tensor(1.3, dtype=torch.float64))
    exact_mean = Ks @ torch.linalg.solve(A, y)
    exact_var = 1.3 - (Ks * torch.linalg.solve(A, Ks.T).T).sum(1)
    assert torch.allclose(mean, exact_mean, atol=1e-6)
    assert torch.allclose(var[:, 0], exact_var, atol=1e-6)


def _mc_prob_largest(mu, var, y, n=2_000_000, seed=1):
    g = torch.Generator().manual_seed(seed)
    f = mu + var.sqrt() * torch.randn(n, *mu.shape, generator=g,
                                      dtype=torch.float64)
    return (f.argmax(-1) == y).double().mean(0)


def test_robust_max_quadrature_against_monte_carlo():
    mu = torch.tensor([[0.3, -0.2, 0.1], [1.0, 1.2, -2.0]],
                      dtype=torch.float64)
    var = torch.tensor([[0.5, 1.0, 0.2], [0.3, 0.1, 2.0]],
                       dtype=torch.float64)
    labels = torch.tensor([0, 1])
    p = ref.prob_is_largest(mu, var, labels)
    mc = _mc_prob_largest(mu, var, labels)
    # the CDFs are squeezed into [1e-4, 1 - 1e-4] (GPflow's RobustMax):
    # a shift of at most 2e-4 a factor
    assert torch.allclose(p, mc, atol=3e-3)


def test_robust_max_limits_and_predictive_probabilities_sum_to_one():
    mu = torch.tensor([[4.0, 0.0, -4.0]], dtype=torch.float64)
    var = torch.full((1, 3), 1e-6, dtype=torch.float64)
    p = ref.prob_is_largest(mu, var, torch.tensor([0]))
    assert abs(float(p) - (1 - 1e-4) ** 2) < 1e-6
    config = {"likelihood": {"type": "MultiClass", "num_classes": 3}}
    Fmu = torch.randn(2, 5, 3, dtype=torch.float64)
    Fvar = torch.rand(2, 5, 3, dtype=torch.float64) + 0.1
    probs, _ = ref.predict_y(config, {}, Fmu, Fvar, block=3)
    assert torch.allclose(probs.sum(-1), torch.ones(2, 5,
                                                    dtype=torch.float64),
                          atol=2e-3)


def test_gaussian_expectation_against_monte_carlo():
    config = {"likelihood": {"type": "Gaussian"}}
    params = {"likelihood.variance": ref.positive_inverse(
        torch.tensor(0.3, dtype=torch.float64))}
    Fmu = torch.tensor([[[0.2], [1.0]]], dtype=torch.float64)
    Fvar = torch.tensor([[[0.5], [0.1]]], dtype=torch.float64)
    Y = torch.tensor([[0.0], [2.0]], dtype=torch.float64)
    ve = ref.variational_expectations(config, params, Fmu, Fvar, Y)
    g = torch.Generator().manual_seed(2)
    f = Fmu + Fvar.sqrt() * torch.randn(1_000_000, 1, 2, 1, generator=g,
                                        dtype=torch.float64)
    v = 0.3 + ref.FLOOR
    logp = -0.5 * math.log(2 * math.pi * v) - 0.5 * (Y - f) ** 2 / v
    assert torch.allclose(ve, logp.mean(0).sum(-1), atol=2e-3)


def test_kl_against_its_dense_formula():
    X, _, _ = _gp_case(seed=3, n=6)
    config = dict(CONFIG, num_outputs=2, numerics={"jitter": 1e-6})
    params, _ = ref.init_params(config, X, X)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        params["layers.0.q_mu"].copy_(torch.randn(6, 2, generator=g,
                                                  dtype=torch.float64))
        params["layers.0.q_sqrt"].mul_(0.5)
    kl = ref.kl(config, params, 0)
    *_, L, _ = ref.layer_factor(config, params, 0)
    K = L @ L.T
    total = 0.0
    for d in range(2):
        Lq = torch.tril(params["layers.0.q_sqrt"][d])
        S = Lq @ Lq.T
        mu = params["layers.0.q_mu"][:, d]
        total += 0.5 * (torch.trace(torch.linalg.solve(K, S))
                        + mu @ torch.linalg.solve(K, mu) - 6
                        + torch.logdet(K) - torch.logdet(S))
    assert torch.allclose(kl, total, rtol=1e-9)


def test_adam_is_optax_formula():
    p = torch.tensor([1.0, -2.0], dtype=torch.float64)
    adam = ref.Adam([p], lr=0.1)
    grads = [torch.tensor([0.5, -0.1], dtype=torch.float64),
             torch.tensor([-0.2, 0.3], dtype=torch.float64)]
    want, m, v = np.array([1.0, -2.0]), np.zeros(2), np.zeros(2)
    for t, g in enumerate(grads, 1):
        adam.step([g])
        g = g.numpy()
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        want = want - 0.1 * (m / (1 - 0.9 ** t)) / (
            np.sqrt(v / (1 - 0.999 ** t)) + 1e-8)
    assert np.allclose(p.numpy(), want, rtol=1e-12)


@pytest.mark.parametrize("base,index", [(0, 0), (2 ** 62 + 5, 17)])
def test_derive_seed_is_the_documented_seed_sequence(base, index):
    state = np.random.SeedSequence([base, index]).generate_state(
        1, np.uint64)[0]
    assert derive_seed(base, index) == int(state) & (2 ** 63 - 1)
