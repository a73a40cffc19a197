"""Plain PyTorch reference of the doubly-stochastic deep GP (Salimbeni and
Deisenroth 2017) as the benchmark's configurations state it.

It imports neither JAX nor the program: only torch and numpy.  Every
quantity the program derives is worked out here again from the inputs
the benchmark made (data, inducing inputs, drawn posteriors):

- the layer stack of the paper's ``init_layers_linear``: a dim-matched
  inner layer has the identity mean function, a narrowing one the frozen
  projection on the top principal directions of its running inputs (the
  right singular vectors of the uncentred inputs, by numpy's SVD, as
  the reference code computes them), a widening one the identity padded
  with zeros; the inducing inputs are pushed through each projection;
  q_mu starts at 0 and q_sqrt at the Cholesky factor of the layer's
  prior covariance Kuu, scaled where the configuration says;
- each layer's parameters in the unconstrained form the optimizer moves:
  variances and lengthscales through softplus(u) + 1e-6, q_sqrt as a full
  matrix whose strict upper triangle is masked out;
- the sparse conditional by triangular solves (the textbook form, not
  the program's staged inverse), its reparameterized sample mean + z
  sqrt(var + jitter), the Gaussian likelihood in closed form and the
  robust-max multiclass likelihood by Gauss-Hermite quadrature over the
  selected dimension of a product of normal CDFs, the KL of each layer,
  the minibatch ELBO and the optax form of Adam;
- the program's random draws (``draws.py``).

The drivers call two entry points: ``train_side`` (the first Adam steps
of a training cell) and ``posterior_params`` with ``request_outputs``
(the answers of a serving cell's requests).

Float64 by default.  ``dtype`` and ``tf32`` compute it in float32 with or
without TF32 matrix products, the control that a lower precision must
fail.  Row-wise work is done in blocks of rows so that B = 100,000 fits.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import numpy as np
import torch

from .draws import derive_seed, request_draws, train_draws

FLOOR = 1e-6                  # softplus lower bound of positive parameters
GH_POINTS = 20                # Gauss-Hermite points of the likelihoods
ROBUST_MAX_EPS = 1e-3
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
BLOCK_ROWS = 20000


def positive(u):
    return torch.logaddexp(u, torch.zeros_like(u)) + FLOOR


def positive_inverse(v):
    v = v - FLOOR
    return v + torch.log(-torch.expm1(-v))


@contextmanager
def matmul_precision(tf32):
    """TF32 matrix products on (``tf32``) or off, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = bool(tf32)
    torch.backends.cudnn.allow_tf32 = bool(tf32)
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def rbf(X, Z, lengthscales, variance):
    """variance exp(-|x - z|^2 / 2) over lengthscale-scaled inputs, (N, M),
    with |x - z|^2 = |x|^2 + |z|^2 - 2 x.z clipped at 0."""
    Xs, Zs = X / lengthscales, Z / lengthscales
    r2 = ((Xs * Xs).sum(-1)[:, None] + (Zs * Zs).sum(-1)[None, :]
          - 2.0 * Xs @ Zs.T)
    return variance * torch.exp(-0.5 * torch.clamp(r2, min=0.0))


def layer_widths(config):
    dims = [config["input_dim"]] + list(config["hidden_dims"])
    outs = list(config["hidden_dims"]) + [config["num_outputs"]]
    return list(zip(dims, outs))


def _white(config, l):
    return (config["inner_white_variance"]
            if l < len(layer_widths(config)) - 1 else 0.0)


def init_params(config, X, Z, dtype=torch.float64):
    """(params, frozen): the unconstrained trainable leaves by name, as
    tensors that require grad, and the frozen mean-function projections.
    ``X`` (N, Dx) and ``Z`` (M, Dx) float64 tensors on the device."""
    device = X.device
    kern = config["kernel"]
    jitter = config["numerics"]["jitter"]
    widths = layer_widths(config)
    running = X.detach().cpu().numpy().astype(np.float64)
    Zrun = Z.detach().cpu().numpy().astype(np.float64)
    params, frozen = {}, {}

    def leaf(name, value):
        # a copy of its own: layers of one width share the running arrays
        params[name] = torch.as_tensor(value, dtype=torch.float64).to(
            device=device, dtype=dtype).detach().clone().requires_grad_(True)

    for l, (Dx, Do) in enumerate(widths):
        last = l == len(widths) - 1
        ls = torch.full((Dx,), float(kern["lengthscales"]),
                        dtype=torch.float64)
        var = torch.tensor(float(kern["variance"]), dtype=torch.float64)
        Zl = torch.as_tensor(Zrun, dtype=torch.float64)
        Kuu = (rbf(Zl, Zl, ls, var)
               + (_white(config, l) + jitter) * torch.eye(Zl.shape[0],
                                                          dtype=torch.float64))
        Lu = torch.linalg.cholesky(Kuu)
        scale = 1.0 if last else config.get("inner_q_sqrt_scale", 1.0)
        q_sqrt = (Lu * scale)[None].repeat(Do, 1, 1)
        leaf(f"layers.{l}.kern.variance", positive_inverse(var))
        leaf(f"layers.{l}.kern.lengthscales", positive_inverse(ls))
        leaf(f"layers.{l}.Z", Zl)
        leaf(f"layers.{l}.q_mu", torch.zeros(Zl.shape[0], Do,
                                             dtype=torch.float64))
        leaf(f"layers.{l}.q_sqrt", torch.tril(q_sqrt))
        if not last and Dx != Do:
            if Dx > Do:
                _, _, vt = np.linalg.svd(running, full_matrices=False)
                W = np.ascontiguousarray(vt[:Do].T)
            else:
                W = np.pad(np.eye(Dx), ((0, 0), (0, Do - Dx)))
            frozen[f"layers.{l}.mean_W"] = torch.as_tensor(W).to(
                device=device, dtype=dtype)
            running = running @ W
            Zrun = Zrun @ W
    lik = config["likelihood"]
    if lik["type"] == "Gaussian":
        leaf("likelihood.variance", positive_inverse(
            torch.tensor(float(lik["variance"]), dtype=torch.float64)))
    return params, frozen


def _mean_fn(config, frozen, l, X):
    widths = layer_widths(config)
    if l == len(widths) - 1:
        return torch.zeros(*X.shape[:-1], widths[l][1], dtype=X.dtype,
                           device=X.device)
    W = frozen.get(f"layers.{l}.mean_W")
    return X if W is None else X @ W


def layer_factor(config, params, l):
    """(lengthscales, variance, Z, q_mu, q_sqrt, L, Kdiag) of layer l, L
    the Cholesky factor of Kuu + (white + jitter) I."""
    ls = positive(params[f"layers.{l}.kern.lengthscales"])
    var = positive(params[f"layers.{l}.kern.variance"])
    Z = params[f"layers.{l}.Z"]
    q_mu = params[f"layers.{l}.q_mu"]
    q_sqrt = torch.tril(params[f"layers.{l}.q_sqrt"])
    jitter = config["numerics"]["jitter"]
    white = _white(config, l)
    eye = torch.eye(Z.shape[0], dtype=Z.dtype, device=Z.device)
    L = torch.linalg.cholesky(rbf(Z, Z, ls, var) + (white + jitter) * eye)
    return ls, var, Z, q_mu, q_sqrt, L, var + white


def conditional(config, params, frozen, l, X, block=BLOCK_ROWS):
    """Mean and variance (B, Do) of layer l's sparse conditional at X (B,
    Dx), by triangular solves: A = L^-1 Kuf, Bm = L^-T A, mean = Bm^T q_mu
    + m(X), var = Kdiag - colsum(A^2) + colsum((q_sqrt_d^T Bm)^2)."""
    ls, var, Z, q_mu, q_sqrt, L, kdiag = layer_factor(config, params, l)
    means, variances = [], []
    for start in range(0, X.shape[0], block):
        Xb = X[start:start + block]
        Kuf = rbf(Z, Xb, ls, var)
        A = torch.linalg.solve_triangular(L, Kuf, upper=False)
        Bm = torch.linalg.solve_triangular(L.T, A, upper=True)
        mean = Bm.T @ q_mu + _mean_fn(config, frozen, l, Xb)
        SB = q_sqrt.transpose(-1, -2) @ Bm                    # (Do, M, b)
        v = (kdiag - (A * A).sum(0))[:, None] + (SB * SB).sum(1).T
        means.append(mean)
        variances.append(torch.clamp(v, min=0.0))
    return torch.cat(means), torch.cat(variances)


def propagate(config, params, frozen, X, zs):
    """(Fmean, Fvar) of the last layer, (S, N, Do), sampling through every
    layer: X (N, Dx) tiled to the S of the draws ``zs`` (one (S, N, Do_l)
    tensor a layer)."""
    jitter = config["numerics"]["jitter"]
    S, N = zs[0].shape[0], X.shape[0]
    F = X[None].expand(S, *X.shape).reshape(S * N, -1)
    for l, z in enumerate(zs):
        mean, var = conditional(config, params, frozen, l, F)
        if l == len(zs) - 1:
            Do = mean.shape[-1]
            return mean.reshape(S, N, Do), var.reshape(S, N, Do)
        F = mean + z.reshape(S * N, -1).to(mean.dtype) * torch.sqrt(
            var + jitter)


def _gh(dtype, device):
    x, w = np.polynomial.hermite.hermgauss(GH_POINTS)
    return (torch.as_tensor(x, dtype=dtype, device=device),
            torch.as_tensor(w / np.sqrt(np.pi), dtype=dtype, device=device))


def prob_is_largest(Fmu, Fvar, labels):
    """P[f_y >= f_j for every j] under independent N(Fmu, Fvar), (..., N):
    Gauss-Hermite over f_y of the product of the other dimensions' normal
    CDFs (GPflow's RobustMax, CDFs squeezed into [1e-4, 1 - 1e-4]).
    ``labels`` (N,) int64."""
    x, w = _gh(Fmu.dtype, Fmu.device)
    K = Fmu.shape[-1]
    oh = (labels[:, None] == torch.arange(K, device=Fmu.device)).to(
        Fmu.dtype)
    mu_y = (Fmu * oh).sum(-1, keepdim=True)
    var_y = torch.clamp((Fvar * oh).sum(-1, keepdim=True), min=1e-10)
    f = mu_y + torch.sqrt(2.0 * var_y) * x                  # (..., N, H)
    dist = (f[..., None, :] - Fmu[..., None]) / torch.sqrt(
        torch.clamp(Fvar, min=1e-10)[..., None])           # (..., N, K, H)
    cdf = 0.5 * (1.0 + torch.erf(dist / math.sqrt(2.0)))
    cdf = cdf * (1.0 - 2e-4) + 1e-4
    cdf = torch.where(oh[..., None] > 0, torch.ones_like(cdf), cdf)
    return (cdf.prod(-2) * w).sum(-1)


def variational_expectations(config, params, Fmu, Fvar, Y):
    """E[log p(y | f)] under N(Fmu, Fvar), summed over the outputs: (S, N)."""
    lik = config["likelihood"]
    if lik["type"] == "Gaussian":
        v = positive(params["likelihood.variance"])
        return (-0.5 * math.log(2 * math.pi) - 0.5 * torch.log(v)
                - 0.5 * ((Y - Fmu) ** 2 + Fvar) / v).sum(-1)
    K = lik["num_classes"]
    p = prob_is_largest(Fmu, Fvar, Y[:, 0].long())
    return (p * math.log(1.0 - ROBUST_MAX_EPS)
            + (1.0 - p) * math.log(ROBUST_MAX_EPS / (K - 1)))


def predict_y(config, params, Fmu, Fvar, block=BLOCK_ROWS // 10):
    """The predictive mean and variance of y per sample, (S, N, D)."""
    lik = config["likelihood"]
    if lik["type"] == "Gaussian":
        return Fmu, Fvar + positive(params["likelihood.variance"])
    K, eps = lik["num_classes"], ROBUST_MAX_EPS
    S, N, _ = Fmu.shape
    mu, fm, fv = [], Fmu.reshape(S * N, K), Fvar.reshape(S * N, K)
    for start in range(0, S * N, block):
        m, v = fm[start:start + block], fv[start:start + block]
        p = torch.stack([prob_is_largest(
            m, v, torch.full((m.shape[0],), k, device=m.device))
            for k in range(K)], dim=-1)
        mu.append(p * (1.0 - eps) + (1.0 - p) * (eps / (K - 1)))
    mu = torch.cat(mu).reshape(S, N, K)
    return mu, mu - mu * mu


def kl(config, params, l):
    """KL(N(q_mu, q_sqrt q_sqrt^T) || N(0, Kuu)) of layer l, summed over
    its outputs."""
    _, _, _, q_mu, q_sqrt, L, _ = layer_factor(config, params, l)
    M, Do = q_mu.shape
    alpha = torch.linalg.solve_triangular(L, q_mu, upper=False)
    LiQ = torch.linalg.solve_triangular(L.expand(Do, M, M), q_sqrt,
                                        upper=False)
    logdet_K = 2.0 * torch.log(torch.diagonal(L)).sum()
    logdet_S = torch.log(torch.diagonal(q_sqrt, dim1=-2, dim2=-1) ** 2).sum()
    return 0.5 * ((alpha * alpha).sum() + (LiQ * LiQ).sum() - M * Do
                  + Do * logdet_K - logdet_S)


def neg_elbo(config, params, frozen, X, Y, zs, num_data):
    """The negative doubly-stochastic ELBO on the minibatch (X, Y) with
    the draws ``zs``: -(num_data / B) sum E[log p] + sum KL, E over the
    S samples by their mean."""
    Fmu, Fvar = propagate(config, params, frozen, X, zs)
    ve = variational_expectations(config, params, Fmu, Fvar, Y).mean(0)
    total_kl = sum(kl(config, params, l)
                   for l in range(len(layer_widths(config))))
    return -(ve.sum() * (num_data / X.shape[0])) + total_kl


class Adam:
    """optax.adam with its defaults: m <- b1 m + (1 - b1) g, v <- b2 v +
    (1 - b2) g^2, p <- p - lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) +
    eps)."""

    def __init__(self, params, lr):
        self.params, self.lr, self.t = list(params), float(lr), 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        c1, c2 = 1.0 - ADAM_B1 ** self.t, 1.0 - ADAM_B2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
            v.mul_(ADAM_B2).add_(g * g, alpha=1.0 - ADAM_B2)
            p.sub_(self.lr * (m / c1) / (torch.sqrt(v / c2) + ADAM_EPS))


def program_dtype(config):
    """The dtype the program computes and draws its normals in."""
    return getattr(torch, config["numerics"]["dtype"])


def _as(t, dtype):
    return t.to(dtype) if t.is_floating_point() else t


def posterior_params(config, inputs, dtype=torch.float64):
    """(params, frozen) of the built model with the drawn posterior,
    detached, in ``dtype``: the initial stack, q_mu = Lu v (Lu its own
    factor of the prior Kuu) and q_sqrt the initial factor times T."""
    data = inputs["data"]
    params, frozen = init_params(config, data["X"].double(),
                                 inputs["Z"].double(), torch.float64)
    with torch.no_grad():
        for l, (v, T) in enumerate(inputs["posterior"]):
            Lu = layer_factor(config, params, l)[5]
            params[f"layers.{l}.q_mu"].copy_(Lu @ v)
            q = params[f"layers.{l}.q_sqrt"]
            q.copy_(torch.tril(torch.tril(q) @ T))
    return ({n: p.detach().to(dtype) for n, p in params.items()},
            {n: w.to(dtype) for n, w in frozen.items()})


def train_side(config, traffic, inputs, seed, dtype=torch.float64,
               tf32=False):
    """The first ``check_chunks`` x ``chunk_steps`` Adam steps from the
    drawn posterior, with the minibatches and normals of a program
    generator seeded with ``seed`` drawn again: {"chunk_losses" (each
    chunk's mean loss), "moments" (Adam's first moment after the first
    chunk), "init", "after" (the leaves before and after the steps),
    "first_grads" (the norm of each leaf's first gradient)}."""
    X, Y = inputs["data"]["X"], inputs["data"]["Y"]
    N, k = X.shape[0], traffic["chunk_steps"]
    steps = traffic["check_chunks"] * k
    with matmul_precision(tf32):
        params, frozen = posterior_params(config, inputs, dtype)
        for p in params.values():
            p.requires_grad_(True)
        names = list(params)
        init = {n: p.detach().clone() for n, p in params.items()}
        adam = Adam(params.values(), config["learning_rate"])
        draws = train_draws(seed, steps, N, config["minibatch"],
                            config["num_samples"], layer_widths(config),
                            X.device, program_dtype(config))
        losses, first, moments = [], None, None
        Xd, Yd = X.to(dtype), Y.to(dtype)
        for s, (idx, zs) in enumerate(draws):
            Xb, Yb = (Xd, Yd) if idx is None else (Xd[idx], Yd[idx])
            loss = neg_elbo(config, params, frozen, Xb, Yb,
                            [_as(z, dtype) for z in zs], num_data=N)
            grads = torch.autograd.grad(loss, list(params.values()))
            if s == 0:
                first = {n: float(g.double().norm())
                         for n, g in zip(names, grads)}
            adam.step(grads)
            losses.append(float(loss.detach()))
            if s + 1 == k:
                moments = {n: m.detach().clone()
                           for n, m in zip(names, adam.m)}
        after = {n: p.detach().clone() for n, p in params.items()}
    return {"chunk_losses": [float(np.mean(losses[i:i + k]))
                             for i in range(0, steps, k)],
            "moments": moments, "init": init, "after": after,
            "first_grads": first}


@torch.no_grad()
def request_outputs(config, traffic, params, frozen, base_seed, index, X,
                    dtype=torch.float64, tf32=False):
    """(mean, var) as float64 numpy arrays of request ``index`` of a
    server seeded with ``base_seed``, X its rows as numpy."""
    device = next(iter(params.values())).device
    with matmul_precision(tf32):
        Xd = torch.as_tensor(X, device=device).to(dtype)
        zs = request_draws(derive_seed(base_seed, index), traffic["samples"],
                           X.shape[0], layer_widths(config), device,
                           program_dtype(config))
        Fmu, Fvar = propagate(config, params, frozen, Xd,
                              [_as(z, dtype) for z in zs])
        mean, var = predict_y(config, params, Fmu, Fvar)
    return mean.double().cpu().numpy(), var.double().cpu().numpy()
